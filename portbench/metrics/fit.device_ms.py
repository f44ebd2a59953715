"""Device ms per frame of the kernels launched under the fitter
(``models/fitter.py::fit_to_image``)."""


def read(trace):
    return trace["range_device_ms"].get("fit")
