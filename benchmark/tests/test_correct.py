"""`correct` on the CPU at a small size: sound runs pass; the control and
each fault a cell can have fail.  (The card's own runs and readings are in
PERF.md.)"""

import jax.numpy as jnp
import numpy as np
import pytest

from benchmark import run
from benchmark.correct import block_errors, decide

SEED = 2**31 + 12345
SMALL = {
    "mode0_srds.live": dict(stations=6, pool_steps=4, distinct_captures=2,
                            check_stations=3, warmup_steps=2),
    "mode2_srds.batch": dict(stations=3, distinct_captures=2,
                             check_stations=3, warmup_steps=1),
}
SECONDS = {"mode0_srds.live": 0.4, "mode2_srds.batch": 1.5}


def _run(cell, **kw):
    return run.run_cell(cell, SEED, SECONDS[cell], False, require_chip=False,
                        overrides=SMALL[cell], **kw)


def _state_unchanged(rx, step):
    def f(state, x):
        _, out = step(state, x)
        return state, out
    return f


def _half_batch(rx, step):
    def f(state, x):
        state, out = step(state, x)
        h = x.shape[0] // 2
        return state, {k: jnp.concatenate([v[:h], v[:h], v[:x.shape[0]
                                                            - 2 * h]])
                       for k, v in out.items()}
    return f


def _answer_altered(rx, step, at=4):
    calls = [0]

    def f(state, x):
        state, out = step(state, x)
        calls[0] += 1
        if calls[0] == at:          # one block of the last station, in the
            # window (the warm-up makes the first two calls)
            out = dict(out, left=out["left"].at[-1].multiply(-1.0))
        return state, out
    return f


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_the_control_is_not(cell):
    res = _run(cell, control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    assert not decide(res["control_checks"], limits), res["control_checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_faults_are_not_correct(cell, fault):
    res = _run(cell, step_wrapper=fault)
    assert not res["correct"], res["checks"]


def test_block_errors_flags_one_bad_block_and_nonfinite():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(2, 40 * 10))
    served = ref.reshape(2, 40, 10).copy()
    assert block_errors({"x": served}, {"x": ref})["x_err"] == 0.0
    served[1, 17, 3] += 5.0
    assert block_errors({"x": served}, {"x": ref})["x_err"] > 1.0
    served[0, 0, 0] = np.nan
    assert block_errors({"x": served}, {"x": ref})["x_err"] == float("inf")
    assert not decide({"x_err": float("inf")}, {"x_err": 1.0})
    assert not decide({}, {"x_err": 1.0})
