"""Host-to-device time of one step's u8 batch: from the client's `h2d` span
opening to the end of that step's last copy on the card (the staging of
pageable host memory plus the DMA), averaged over the traced steps."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    s = trace.h2d_latency_per_step(run.trace)
    return None if s is None else s * 1e3
