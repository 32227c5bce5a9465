"""Open loop: every station's next block comes due on the real-time
schedule, whether or not the server kept up.

Block k of all stations is due when its last sample would have arrived,
t0 + (k + 1) * step_seconds.  The loop dispatches a block once it is due,
fetches outputs whenever the next block is not yet due, and dispatches up
to `lookahead` blocks ahead of the oldest unfetched one only when it has
fallen behind.  Blocks due in the window are all served; a loop that falls
more than `give_up_s` behind its schedule stops dispatching, and the blocks
it never sent count as failed.
"""

from __future__ import annotations

import collections
import time

from jax.profiler import TraceAnnotation

from benchmark.client import StepRecord


def drive(session, mix: dict, seconds: float) -> dict:
    step_s = float(mix["step_seconds"])      # set by the harness
    lookahead = int(mix["lookahead"])
    give_up_s = float(mix["give_up_s"])
    total = int(seconds / step_s + 1e-9)
    t0 = session.open()
    pending: collections.deque = collections.deque()
    k = 0
    unsent = 0
    while k < total or pending:
        now = time.perf_counter()
        due = t0 + (k + 1) * step_s if k < total else float("inf")
        if k < total and now - due > give_up_s:
            unsent = total - k
            k = total
            continue
        if pending and (due > now or len(pending) > lookahead):
            session.fetch(*pending.popleft())
        elif due <= now:
            rec = StepRecord(k, due)
            pending.append((rec, session.dispatch(rec, session.put(k))))
            k += 1
        else:
            with TraceAnnotation("wait_due"):
                time.sleep(max(0.0, due - now))
    return {"blocks": total, "unsent": unsent, "t0": t0,
            "window_s": seconds}
