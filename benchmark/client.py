"""What the client loops share: the served path and its records.

One step of the served path is the program's own entry, `jax.jit(
Receiver.step)`, fed the u8 batch from the host and drained back to the
host: `put` moves the step's block to the device, `dispatch` calls the
step, `fetch` brings every output (`mono`, `left`, `right`, `rds_soft`)
back.  Each sits in a host span (`pool.fetch`, `h2d`, `dispatch`, `d2h`,
and `wait_due` in the open loop) that a profiler trace records beside the
device's own events.

A thread off the critical path checks that every fetched station-block is
finite; the rows of the sampled stations are kept for the comparison with
the reference.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import jax
import numpy as np
from jax.profiler import TraceAnnotation


@dataclasses.dataclass
class StepRecord:
    k: int
    due: float | None       # open loop: when the block's last sample arrives
    put: float = 0.0        # client clock at each stage, for the run's log
    dispatched: float = 0.0
    returned: float = 0.0
    fetch: float = 0.0
    done: float | None = None


def latencies_ms(records) -> np.ndarray:
    """Outputs on the host less due time, in ms, of every block that came
    due (the open loop's records; the closed loop's have no due time)."""
    return np.asarray([r.done - r.due for r in records
                       if r.due is not None and r.done is not None]) * 1e3


class FiniteCheck:
    """Counts station-blocks with a non-finite output, in its own thread
    (numpy's reductions release the interpreter lock)."""

    def __init__(self):
        self.bad = 0
        self._q: queue.Queue = queue.Queue()
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        while True:
            host = self._q.get()
            if host is None:
                return
            bad = None
            for v in host.values():
                rows = ~np.isfinite(v.reshape(v.shape[0], -1).sum(axis=1))
                bad = rows if bad is None else bad | rows
            self.bad += int(bad.sum())

    def submit(self, host: dict):
        self._q.put(host)

    def close(self) -> int:
        self._q.put(None)
        self._t.join(timeout=600)
        if self._t.is_alive():
            raise RuntimeError("finite check did not finish")
        return self.bad


class Tracer:
    """Traces one steady stretch of the window with jax.profiler: from
    `start_s` after the window opens, for `length_s`."""

    def __init__(self, directory: str | None, start_s: float,
                 length_s: float):
        self.directory = directory
        self.start_s, self.length_s = start_s, length_s
        self.state = "off"

    def tick(self, elapsed: float):
        if self.directory is None:
            return
        if self.state == "off" and elapsed >= self.start_s:
            jax.profiler.start_trace(self.directory)
            self.state = "on"
        elif self.state == "on" and elapsed >= self.start_s + self.length_s:
            self.stop()

    def stop(self):
        if self.state == "on":
            jax.profiler.stop_trace()
            self.state = "done"


class Session:
    """The served path of one cell, driven by a client loop."""

    def __init__(self, step, state, pool, rows, tracer: Tracer):
        self.step = step
        self.state = state
        self.pool = pool
        self.rows = np.asarray(rows)
        self.tracer = tracer
        self.records: list[StepRecord] = []
        self.kept: dict[str, list[np.ndarray]] = {}
        self.check = FiniteCheck()
        self.t0 = 0.0
        self.put_at = 0.0

    def open(self):
        self.t0 = time.perf_counter()
        return self.t0

    def put(self, k: int):
        self.put_at = time.perf_counter()
        self.tracer.tick(self.put_at - self.t0)
        with TraceAnnotation("pool.fetch"):
            block = self.pool.block(k)
        with TraceAnnotation("h2d"):
            return jax.device_put(block)

    def dispatch(self, rec: StepRecord, x):
        rec.put = self.put_at
        with TraceAnnotation("dispatch"):
            rec.dispatched = time.perf_counter()
            self.state, out = self.step(self.state, x)
        rec.returned = time.perf_counter()
        self.records.append(rec)
        return out

    def fetch(self, rec: StepRecord, out):
        rec.fetch = time.perf_counter()
        with TraceAnnotation("d2h"):
            host = jax.device_get(out)
        rec.done = time.perf_counter()
        for key, v in host.items():
            self.kept.setdefault(key, []).append(v[self.rows].copy())
        self.check.submit(host)

    def close(self):
        self.tracer.stop()
        return self.check.close()
