"""Multi-host (DCN) execution: really run `jax.distributed` with 2 OS
processes (SURVEY §5.8, §4.3 'distributed testing').

The parent spawns two fresh interpreters with JAX_PLATFORMS=cpu and 4
virtual devices each BEFORE interpreter start (the env must be set before
any jax import), so the pair forms a 2-process x 4-device = 8-device global
mesh over the coordination service — the same code path a multi-host GPU
cluster uses, with per-host input feeding.  See tests/multihost_worker.py for what
each process does.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_execution():
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_NUM_PROCESSES", None)
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST_OK proc={i}/2 global_devices=8 local_devices=4" \
            in out, f"worker {i} output:\n{out}"
