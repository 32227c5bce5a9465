"""The front end's share of its roofline: the least time its work needs
(benchmark/work/frontend.py against the card's peaks) over the device time
of its kernels, per step.  Nothing is returned where no front-end kernel
was traced."""

from benchmark import trace
from benchmark.work import frontend


def read(run):
    td = run.trace
    if td is None or td.steps == 0:
        return None
    fe = trace.frontend_kernels(td)
    if not fe:
        return None
    per_step = sum(k.end - k.start for k in fe) / td.steps
    m = run.config["mode"]
    work = frontend.counts(run.stations, run.step_iq, m["rf_taps"],
                           m["rf_decim"])
    least, bound = frontend.least_time(work, run.peak)
    run.notes.append(f"frontend roofline: least {least * 1e3:.6f} ms "
                     f"({bound}-bound) vs {per_step * 1e3:.6f} ms per step")
    return 100.0 * least / per_step
