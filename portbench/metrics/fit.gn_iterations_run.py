"""Gauss-Newton iterations the fitter ran per frame, the mean over every
frame of the run: the port's counter ``fit.gn_iterations`` (one per
``gauss_newton_step``) over its counter ``frames``. ``fit.gn_iterations``
reads the diagnostics, which the fitter pads to the schedule's length; this
one sees the convergence exit."""

from portbench.program import per_frame


def read(trace):
    return per_frame(trace, "fit.gn_iterations")
