"""Device ms per frame of the kernels launched under rigid odometry
(``ops/rigid_odometry.py::rigid_odometry_multi_scale``)."""


def read(trace):
    return trace["range_device_ms"].get("odometry")
