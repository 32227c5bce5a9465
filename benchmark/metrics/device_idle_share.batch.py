"""Share of the traced window in which no kernel ran on the card:
1 - (union of kernel intervals) / window."""


def read(run):
    td = run.trace
    if td is None or td.window_s <= 0 or not td.kernels:
        return None
    return 100.0 * (1.0 - td.busy_s() / td.window_s)
