"""Device ms per frame of the kernels launched under the neural prior
(``FusionPipeline._apply_prior``: DeformNet and the prior's GN)."""


def read(trace):
    return trace["range_device_ms"].get("prior")
