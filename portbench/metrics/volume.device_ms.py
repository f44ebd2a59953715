"""Device ms per frame of the kernels launched under the TSDF update
(``apps/fusion_pipeline.py::volume_update``) and the canonical mesh's
extraction (``FusionPipeline._refresh_canonical_mesh``)."""


def read(trace):
    return trace["range_device_ms"].get("volume")
