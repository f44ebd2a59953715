"""Host ms per frame of the SOD loop's PNG codec: the port's spans
``sod.read`` (a colour frame read and decoded) and ``sod.write`` (a mask
encoded and written) in the traced batches, over their frames."""


def read(trace):
    ms = trace.get("span_host_ms", {})
    if "sod.read" not in ms and "sod.write" not in ms:
        return None
    return ms.get("sod.read", 0.0) + ms.get("sod.write", 0.0)
