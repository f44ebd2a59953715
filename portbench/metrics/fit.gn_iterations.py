"""Gauss-Newton iterations per frame, the mean over the window's frames: the
length of ``process_frame``'s ``data_loss`` (the fitter stops early once an
update falls under its threshold)."""


def read(trace):
    return trace.get("gn_iterations")
