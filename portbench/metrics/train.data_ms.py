"""Host ms per batch of the data path (the dataset's batch from the PNG
split, node ground truth, match uniforms, the move to the device), the
median over the window's steps."""


def read(trace):
    return trace.get("data_ms")
