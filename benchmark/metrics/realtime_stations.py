"""Station-seconds of signal whose outputs reached the host in the window,
over the window's wall seconds: all the work over all the time."""


def read(run):
    done = [r for r in run.records if r.done is not None]
    if not done or run.drive["window_s"] <= 0:
        return None
    return (run.stations * len(done) * run.step_seconds
            / run.drive["window_s"])
