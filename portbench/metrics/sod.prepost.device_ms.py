"""Device ms per frame of the SOD loop's pre- and post-processing on the
card (the bicubic resizes, the per-image maximum and ImageNet
normalization, the min-max and quantization): the device operations under
the port's spans ``sod.preprocess`` and ``sod.postprocess`` in the traced
batches, over their frames."""


def read(trace):
    ms = trace.get("span_device_ms", {})
    if "sod.preprocess" not in ms and "sod.postprocess" not in ms:
        return None
    return ms.get("sod.preprocess", 0.0) + ms.get("sod.postprocess", 0.0)
