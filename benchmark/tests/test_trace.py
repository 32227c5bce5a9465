"""The reducers on a trace recorded on an H100 (mode 0 stereo+RDS, 1024
stations, six steps of put / step / fetch / wait, each in its client span)."""

import os

import pytest

from benchmark import trace

DATA = os.path.join(os.path.dirname(__file__), "data", "probe.xplane.pb")


@pytest.fixture(scope="module")
def td():
    return trace.read(DATA)


def test_window_steps_and_planes(td):
    assert td.devices == 1
    assert td.steps == 6
    assert td.window_s == pytest.approx(0.164978364, rel=1e-6)
    assert len(td.kernels) == 216
    assert sorted({c.kind for c in td.copies}) == ["D2H", "H2D"]
    h2d = [c for c in td.copies if c.kind == "H2D"]
    assert [c.nbytes for c in h2d] == [1024 * 76800] * 6


def test_busy_idle_and_kernels_per_step(td):
    assert td.busy_s() == pytest.approx(0.00974397, rel=1e-5)
    assert 1 - td.busy_s() / td.window_s == pytest.approx(0.940938, rel=1e-5)
    assert len(trace.in_window(td, td.kernels)) / td.steps == 36


def test_frontend_kernels_by_name(td):
    fe = trace.frontend_kernels(td)
    assert [k.name for k in fe] == ["fm_frontend"] * 6
    assert sum(k.end - k.start for k in fe) == pytest.approx(0.001208695,
                                                             rel=1e-6)


def test_h2d_latency_from_span_to_copy_end(td):
    # staging of the pageable batch + DMA: ~17.8 ms per step
    assert trace.h2d_latency_per_step(td) == pytest.approx(0.017807076,
                                                           rel=1e-6)


def test_breakdown(td):
    ops = trace.top_ops(td)
    assert len(ops) == 10 and ops[0][1] >= ops[-1][1]
    assert "fm_frontend" in [n for n, _ in ops]
    gaps = dict(trace.idle_gaps(td))
    assert max(gaps, key=gaps.get) == "during dispatch"
    assert sum(gaps.values()) == pytest.approx(td.window_s - td.busy_s(),
                                               rel=1e-9)


def test_hlo_scopes_map_kernel_names():
    hlo = ('  %input_concatenate_fusion.3 = f32[8,2]{1,0} fusion(%a), '
           'metadata={op_name="jit(step)/rf_frontend/concatenate"}\n'
           '  %loop_slice_fusion = f32[8]{0} fusion(%b), kind=kLoop\n')
    assert trace.hlo_scopes(hlo) == {
        "input_concatenate_fusion_3": "jit(step)/rf_frontend/concatenate"}
