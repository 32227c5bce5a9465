"""From a jax.profiler trace of the window to the numbers the readers use.

The trace (`.xplane.pb`) holds the card's events on the plane
`/device:GPU:<n>`: kernels on the lines named `Stream #<k>(Compute)` and
copies on `Stream #<k>(MemcpyH2D)` / `(MemcpyD2H)` lines, and the host's
TraceMe events, among them the client's spans (`pool.fetch`, `h2d`,
`dispatch`, `d2h`, `wait_due`), on `/host:CPU`.  Both are on one clock.

The traced window runs from the first client span to the end of the last
one; a step is one `dispatch` span.  A kernel's place in the program is its
scope path: the event's own `name` statistic where XLA gives one, else the
`op_name` of the HLO instruction of the same name in the compiled step
(kernels replayed inside a CUDA graph carry no scope of their own).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import numpy as np

CLIENT_SPANS = ("pool.fetch", "h2d", "dispatch", "d2h", "wait_due")
_HLO_LINE = re.compile(r'^\s*%([\w.\-]+) = .*?op_name="([^"]*)"')


@dataclasses.dataclass
class Kernel:
    name: str
    start: float        # seconds on the trace's clock
    end: float
    scope: str


@dataclasses.dataclass
class Copy:
    kind: str           # 'H2D' or 'D2H'
    start: float
    end: float
    nbytes: int


@dataclasses.dataclass
class TraceData:
    kernels: list[Kernel]
    copies: list[Copy]
    spans: dict[str, list[tuple[float, float]]]
    window: tuple[float, float]
    steps: int
    devices: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Union of kernel intervals inside the window, per device merged
        into one list (one card per cell)."""
        lo, hi = self.window
        iv = sorted((max(k.start, lo), min(k.end, hi)) for k in self.kernels
                    if k.end > lo and k.start < hi)
        out: list[list[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / max(
            self.devices, 1)


def hlo_scopes(hlo_text: str) -> dict[str, str]:
    """Kernel name -> op_name, from the compiled step's HLO text (a kernel
    is named after its instruction with '.' written as '_')."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            out[m.group(1).replace(".", "_")] = m.group(2)
    return out


def _memcpy_bytes(details: str) -> int:
    m = re.search(r"size:(\d+)", details or "")
    return int(m.group(1)) if m else 0


def read(path: str, scopes: dict[str, str] | None = None) -> TraceData:
    """Reduce one `.xplane.pb` file (or the newest under a directory)."""
    from jax.profiler import ProfileData
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                                 recursive=True), key=os.path.getmtime)
        if not found:
            raise FileNotFoundError(f"no .xplane.pb under {path}")
        path = found[-1]
    scopes = scopes or {}
    pd = ProfileData.from_file(path)
    kernels, copies = [], []
    spans: dict[str, list[tuple[float, float]]] = {n: [] for n in
                                                    CLIENT_SPANS}
    devices = 0
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU:"):
            devices += 1
            for line in plane.lines:
                if "Memcpy" in line.name:
                    kind = "H2D" if "H2D" in line.name else "D2H"
                    for e in line.events:
                        st = dict(e.stats)
                        t0 = e.start_ns * 1e-9
                        copies.append(Copy(kind, t0, t0 + e.duration_ns
                                           * 1e-9, _memcpy_bytes(
                                               st.get("memcpy_details"))))
                elif "(Compute)" in line.name:
                    for e in line.events:
                        st = dict(e.stats)
                        scope = st.get("name") or scopes.get(e.name, "")
                        t0 = e.start_ns * 1e-9
                        kernels.append(Kernel(e.name, t0,
                                              t0 + e.duration_ns * 1e-9,
                                              str(scope)))
        elif plane.name == "/host:CPU":
            for line in plane.lines:
                for e in line.events:
                    if e.name in spans:
                        t0 = e.start_ns * 1e-9
                        spans[e.name].append((t0, t0 + e.duration_ns * 1e-9))
    for v in spans.values():
        v.sort()
    flat = [iv for v in spans.values() for iv in v]
    window = ((min(a for a, _ in flat), max(b for _, b in flat)) if flat
              else (0.0, 0.0))
    return TraceData(kernels, copies, spans, window, len(spans["dispatch"]),
                     devices)


def in_window(td: TraceData, items):
    lo, hi = td.window
    return [x for x in items if x.start >= lo and x.start < hi]


def frontend_kernels(td: TraceData) -> list[Kernel]:
    """The front end's kernels: the fused u8 kernel (`fm_frontend`) and what
    its scope holds where the program runs it; otherwise everything under
    the `rf_frontend` scope (the plain XLA front end)."""
    ks = in_window(td, td.kernels)
    fused = [k for k in ks if k.name == "fm_frontend"
             or "/fm_frontend/" in k.scope]
    if fused:
        return fused
    return [k for k in ks if "/rf_frontend" in k.scope]


def h2d_latency_per_step(td: TraceData) -> float | None:
    """Mean over traced steps of the time from the client's `h2d` span
    opening to the end of that step's last host-to-device copy on the
    card: the staging of the pageable u8 batch plus the DMA."""
    starts = [a for a, _ in td.spans["h2d"]]
    if not starts:
        return None
    ends: dict[int, float] = {}
    for c in td.copies:
        if c.kind != "H2D":
            continue
        i = int(np.searchsorted(starts, c.start, side="right")) - 1
        if i >= 0:
            ends[i] = max(ends.get(i, c.end), c.end)
    if not ends:
        return None
    return float(np.mean([ends[i] - starts[i] for i in ends]))


def idle_gaps(td: TraceData, top: int = 10) -> list[list]:
    """Idle time of the card inside the window, by the client span that was
    open during each gap (the one overlapping it most; 'host' if none)."""
    lo, hi = td.window
    busy = td.busy_intervals()
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    spans = [(a, b, n) for n, v in td.spans.items() for a, b in v]
    by: dict[str, float] = {}
    for g0, g1 in gaps:
        best, who = 0.0, "host"
        for a, b, n in spans:
            ov = min(b, g1) - max(a, g0)
            if ov > best:
                best, who = ov, n
        by[who] = by.get(who, 0.0) + (g1 - g0)
    return [[f"during {n}", s] for n, s in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(td: TraceData, top: int = 10) -> list[list]:
    """Device time per kernel name inside the window, largest first."""
    by: dict[str, float] = {}
    for k in in_window(td, td.kernels):
        by[k.name] = by.get(k.name, 0.0) + (k.end - k.start)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]
