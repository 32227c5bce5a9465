"""Which device the program runs on, and what follows from it.

One module answers every device question, so no other file compares
backend names:

- `backend()` / `require_gpu()`: the platform JAX selected; measurement
  entry points (bench.py, chip_smoke.py) refuse to run anywhere but a GPU.
- `kernel_interpret()`: the rule for hand-written Pallas kernels.  On a GPU
  they compile for the card.  Anywhere else they raise, unless the caller
  opted into the Pallas interpreter with `interpret_kernels()` (tests do).
  Nothing falls back to the interpreter or to the plain path on its own.
- `bf16_dot_needs_upcast()`: only XLA's CPU backend lacks a
  bf16 x bf16 -> f32 dot.
- `init_compile_cache()`: the persistent compilation cache, honouring
  JAX_COMPILATION_CACHE_DIR and otherwise kept at <checkout>/.jax_cache.
- `gpu_info()`: the card's name and power limit, printed beside every
  number taken on it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading

import jax

_local = threading.local()

# <checkout>/.jax_cache: resolved from this file's own path, so the same
# checkout always finds its cache again (the path is part of the key)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def backend() -> str:
    """The platform of JAX's default backend ('gpu', 'cpu', ...)."""
    return jax.default_backend()


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU, listing what it found."""
    if backend() != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX backend is {backend()!r}, devices "
            f"{jax.devices()}")


@contextlib.contextmanager
def interpret_kernels():
    """Run Pallas kernels in the Pallas interpreter inside this context
    (tests on the CPU).  Kernels traced here keep their interpret mode in
    whatever jit cache entry the trace lands in."""
    prev = getattr(_local, "interpret", False)
    _local.interpret = True
    try:
        yield
    finally:
        _local.interpret = prev


def kernel_interpret() -> bool:
    """The `interpret` flag for a Pallas call being traced now.

    False on a GPU (compile for the card); True inside
    `interpret_kernels()`; otherwise raise — a kernel never silently
    degrades to the interpreter."""
    if getattr(_local, "interpret", False):
        return True
    if backend() == "gpu":
        return False
    raise RuntimeError(
        f"Pallas kernels compile for the GPU only (backend is "
        f"{backend()!r}); use the plain XLA path, or wrap the call in "
        f"sdr_tpu.device.interpret_kernels() to run the interpreter")


def bf16_dot_needs_upcast() -> bool:
    """True where XLA has no bf16 x bf16 -> f32 dot (the CPU backend)."""
    return backend() == "cpu"


def init_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is left
    alone; otherwise the cache goes to <checkout>/.jax_cache.  The minimum
    compile time is lowered so the receiver's step programs are kept."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def gpu_info() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them
    ('not available' where nvidia-smi is missing or fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip()
