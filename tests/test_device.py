"""The device rules (sdr_tpu/device.py) and the GPU-only entry points, as
they behave on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_tpu import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd=REPO, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_require_gpu_raises_on_cpu():
    assert device.backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU found"):
        device.require_gpu()


def test_kernel_rule_raises_outside_interpret_context():
    """Off the GPU a Pallas kernel runs only inside interpret_kernels();
    the context restores the rule on exit."""
    from sdr_tpu.ops import firdes
    from sdr_tpu.ops.pallas.frontend_kernel import FusedFrontend
    fe = FusedFrontend(firdes.lowpass(2.4e6, 100e3, 51, 1), 10)
    u8 = jnp.full((2, 2000), 128, jnp.uint8)
    z = jnp.zeros((2,), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU only"):
        fe(u8, fe.init_state((2,)), z, z)
    with device.interpret_kernels():
        assert device.kernel_interpret() is True
        fm = fe(u8, fe.init_state((2,)), z, z)[0]
    assert fm.shape == (2, 100) and not np.asarray(fm).any()
    with pytest.raises(RuntimeError):
        device.kernel_interpret()


def test_fast_engines_follow_the_backend():
    """--fast takes the front-end kernel only where it compiles; the bf16
    dot upcast is a CPU-only workaround."""
    from sdr_tpu.cli import fast_engines
    assert fast_engines() == dict(fused_frontend=False, pll_impl="ff",
                                  conv_dtype="bf16")
    assert device.bf16_dot_needs_upcast()


@pytest.mark.parametrize("env_dir", [None, "custom"], ids=["unset", "set"])
def test_compile_cache_dir(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured when set; otherwise the cache
    is <checkout>/.jax_cache, resolved from the package path."""
    code = ("import jax; from sdr_tpu import device; "
            "print(device.init_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    extra = {"PYTHONPATH": REPO}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = _python(["-c", code], cwd=str(tmp_path), env_extra=extra,
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    ret, cfg = r.stdout.split()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert ret == cfg == want


def _lowered(fn, *args):
    return jax.jit(fn).lower(*args).as_text()


def _resample(dtype):
    from sdr_tpu.ops.resample import PolyphaseResampler
    r = PolyphaseResampler(np.ones(11, np.float32), 1, 5, compute_dtype=dtype)
    return lambda x: r(x, r.init_state((2,)))[0], jnp.zeros((2, 100))


def _multifir(dtype):
    from sdr_tpu.ops.resample import MultiFIR
    m = MultiFIR([np.ones(5, np.float32)] * 2, compute_dtype=dtype)
    return lambda x: m(x, m.init_state((2,)))[0][0], jnp.zeros((2, 100))


def _banded(dtype):
    from sdr_tpu.ops.banded import TiledBandedFIR
    b = TiledBandedFIR(np.ones(11, np.float32), 1, 5, compute_dtype=dtype)
    return lambda x: b(x, b.init_state((2,)))[0], jnp.zeros((2, 100))


def _channelizer(dtype):
    from sdr_tpu.ops.channelizer import WidebandChannelizer
    c = WidebandChannelizer(9.6e6, 2.4e6, [0.0, 1e6],
                            compute_dtype="bf16" if dtype == jnp.bfloat16
                            else "f32")
    return (lambda x: c.call_interleaved(x, c.init_state())[0][0],
            jnp.zeros((2 * 4 * 256,), jnp.float32))


def _dft(dtype):
    from sdr_tpu.ops.fourier import dft
    return dft, jnp.zeros((64,), jnp.complex64)


@pytest.mark.parametrize("build", [_resample, _multifir, _banded,
                                   _channelizer, _dft],
                         ids=["resample_conv", "multifir_conv",
                              "banded_einsum", "channelizer_gemm", "dft"])
def test_reference_products_request_highest_precision(build):
    """Every f32 conv/dot/einsum of the reference path asks for HIGHEST
    precision in the lowered program (no TF32 on a GPU)."""
    fn, x = build(jnp.float32)
    assert "HIGHEST" in _lowered(fn, x)


@pytest.mark.parametrize("build", [_resample, _banded],
                         ids=["resample_conv", "banded_einsum"])
def test_bf16_products_keep_default_precision(build):
    fn, x = build(jnp.bfloat16)
    assert "HIGHEST" not in _lowered(fn, x)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    """Without a GPU both measurement entry points exit non-zero, say why,
    and print no result."""
    r = _python([script], env_extra={"PYTHONPATH": REPO})
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok": true' not in r.stdout and "metric" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied away from the repo fails without a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _python(["chip_smoke.py"], cwd=str(tmp_path), drop=("PYTHONPATH",))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
