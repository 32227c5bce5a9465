"""Closed loop: the next step is sent as soon as the client may, with
`lookahead` steps in flight: dispatch step k, then fetch the outputs of
step k - lookahead (the policy of `python -m sdr_tpu --stations`, whose
lookahead is 1).  The loop stops dispatching once `seconds` have passed and
drains what is in flight; the window ends when the last outputs are on the
host.
"""

from __future__ import annotations

import collections
import time

from benchmark.client import StepRecord


def drive(session, mix: dict, seconds: float) -> dict:
    lookahead = int(mix["lookahead"])
    t0 = session.open()
    pending: collections.deque = collections.deque()
    k = 0
    while time.perf_counter() - t0 < seconds:
        rec = StepRecord(k, None)
        pending.append((rec, session.dispatch(rec, session.put(k))))
        k += 1
        while len(pending) > lookahead:
            session.fetch(*pending.popleft())
    while pending:
        session.fetch(*pending.popleft())
    return {"blocks": k, "unsent": 0, "t0": t0,
            "window_s": session.records[-1].done - t0}
