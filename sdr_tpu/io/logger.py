"""Signal tracing: .dat dumps for gnuplot-style inspection.

Reference: src/logfunc.cpp:14-43 (`genIndexVector`, `logVector`).  Each dump
is an x/y two-column text file consumed by the reference's gnuplot scripts
(data/example.gnuplot etc.).  Also provides a named-scope profiler shim over
jax.profiler (the device-side analogue of the report template's per-stage
timing requirement, SURVEY §5.1).
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


def gen_index_vector(n: int) -> np.ndarray:
    """0..n-1 index vector (reference src/logfunc.cpp:14-21)."""
    return np.arange(n, dtype=np.float32)


def log_vector(filename: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write '<x>\t<y>' lines with 5-digit precision, .dat suffix
    (reference src/logfunc.cpp:23-43)."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    with open(f"{filename}.dat", "w") as f:
        f.write("# x\ty\n")
        for xi, yi in zip(x, y):
            f.write(f"{xi:.5f}\t{yi:.5f}\n")


class PsdAnimWriter:
    """Streaming multi-frame PSD .dat writer (the P6 animated-PSD parity,
    reference model/fmMonoAnim.py:42-135).

    Frames are separated by two blank lines so gnuplot's `index` keyword
    addresses frame k directly — the format examples/psd_anim.gnuplot
    renders into an animated GIF.  Appends incrementally: O(1) host memory
    on unbounded streams.
    """

    def __init__(self, filename: str, freq: np.ndarray):
        self._freq = np.asarray(freq).ravel()
        self._f = open(f"{filename}.dat", "w")
        self._f.write("# animated PSD series; frame k = gnuplot index k\n")
        self._f.write("# x: frequency (kHz)  y: PSD (dB/Hz)\n")
        self.frames = 0

    def append(self, psd_db: np.ndarray, label: str | None = None) -> None:
        psd_db = np.asarray(psd_db).ravel()
        self._f.write(f"# frame {self.frames}"
                      + (f" ({label})" if label else "") + "\n")
        np.savetxt(self._f, np.column_stack([self._freq, psd_db]),
                   fmt="%.5f", delimiter="\t")
        self._f.write("\n\n")
        self.frames += 1

    def close(self) -> None:
        self._f.close()


@contextlib.contextmanager
def stage_scope(name: str):
    """Named profiling scope: shows up in jax.profiler traces and records
    wall time.  Usage: `with stage_scope('rf_frontend'): ...`."""
    with jax.profiler.TraceAnnotation(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _STAGE_TIMES.setdefault(name, []).append(time.perf_counter() - t0)


_STAGE_TIMES: dict[str, list[float]] = {}


def stage_times() -> dict[str, float]:
    """Mean wall time per recorded stage (seconds)."""
    return {k: float(np.mean(v)) for k, v in _STAGE_TIMES.items()}


def reset_stage_times() -> None:
    _STAGE_TIMES.clear()


def print_real_vector(x, max_elems: int = 10) -> str:
    """Pretty-print helper (reference src/iofunc.cpp:15-21 `printRealVector`)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v:.5f}" for v in x[:max_elems])
    tail = ", ..." if len(x) > max_elems else ""
    return f"[{shown}{tail}] ({len(x)} elems)"


def print_complex_vector(x, max_elems: int = 10) -> str:
    """Pretty-print helper (reference src/iofunc.cpp:23-29 `printComplexVector`)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v.real:.5f}{v.imag:+.5f}j" for v in x[:max_elems])
    tail = ", ..." if len(x) > max_elems else ""
    return f"[{shown}{tail}] ({len(x)} elems)"
