"""Set-up: process start to the first timed step (imports, traffic pool,
compilation or the compile cache's load, warm-up)."""


def read(run):
    return run.setup_s
