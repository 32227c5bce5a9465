"""Kernels launched on the card per step, counted in the traced window."""

from benchmark import trace


def read(run):
    td = run.trace
    if td is None or td.steps == 0:
        return None
    ks = trace.in_window(td, td.kernels)
    return len(ks) / td.steps if ks else None
