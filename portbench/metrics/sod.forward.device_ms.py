"""Device ms per frame of U²-Net's forward in the SOD loop: the device
operations under the port's span ``sod.forward`` (``dfu::sod.forward``,
read by the port's ``utils/trace.py::read_profile``) in the traced batches,
over their frames."""


def read(trace):
    return trace.get("span_device_ms", {}).get("sod.forward")
