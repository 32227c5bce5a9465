"""Device time per step of everything after the front end (IF band-pass
bank, carrier recovery, audio resampler pair, RDS chain): kernel time in
the traced window less the front end's, per step."""

from benchmark import trace


def read(run):
    td = run.trace
    if td is None or td.steps == 0:
        return None
    ks = trace.in_window(td, td.kernels)
    if not ks:
        return None
    fe = sum(k.end - k.start for k in trace.frontend_kernels(td))
    return (sum(k.end - k.start for k in ks) - fe) / td.steps * 1e3
