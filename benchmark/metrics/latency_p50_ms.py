"""The 50th percentile, over every station-block due in the window, of the
time its outputs were all on the host less the time it came due (the
arrival of its last sample).  All stations of a block share one due time
and one fetch, so the percentile is taken over blocks."""

import numpy as np

from benchmark.client import latencies_ms


def read(run):
    lat = latencies_ms(run.records)
    return float(np.percentile(lat, 50)) if lat.size else None
