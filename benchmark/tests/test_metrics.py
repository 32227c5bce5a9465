"""End-to-end arithmetic on synthetic client records."""

import types

import numpy as np
import pytest

from benchmark import manifest as mf
from benchmark.client import StepRecord, latencies_ms


def _reader(name):
    return mf.load_module(mf.metric_path(name)).read


def _open_run(latencies_s, step_s=0.016):
    recs = []
    for k, lat in enumerate(latencies_s):
        due = (k + 1) * step_s
        recs.append(StepRecord(k, due, done=due + lat))
    return types.SimpleNamespace(records=recs, drive={"window_s": 20.0})


def test_latency_percentiles_over_all_blocks():
    lat = np.full(1000, 0.010)
    run = _open_run(lat)
    assert _reader("latency_p50_ms")(run) == pytest.approx(10.0)
    assert latencies_ms(run.records) == pytest.approx(np.full(1000, 10.0))
    assert _reader("latency_p50_ms")(
        types.SimpleNamespace(records=[StepRecord(0, None, done=1.0)])) is None


def test_a_stall_moves_the_tail_and_not_the_median():
    lat = np.full(1000, 0.010)
    # a 300 ms stall: the next blocks wait behind it and drain at 4 ms each
    for j in range(80):
        lat[500 + j] = max(0.010, 0.300 - 0.004 * j)
    run = _open_run(lat)
    assert _reader("latency_p50_ms")(run) == pytest.approx(10.0)
    assert np.percentile(latencies_ms(run.records), 99) > 100.0


def test_realtime_stations_is_all_work_over_all_time():
    recs = [StepRecord(k, None, done=0.1 * (k + 1)) for k in range(50)]
    run = types.SimpleNamespace(records=recs, drive={"window_s": 5.0},
                                stations=128, step_seconds=1.28)
    # 50 steps x 128 stations x 1.28 s of signal in 5 s of wall time
    assert _reader("realtime_stations")(run) == pytest.approx(1638.4)
    recs[-1].done = None                      # a step that never came back
    assert _reader("realtime_stations")(run) == pytest.approx(1605.632)


def test_per_layer_readers_read_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None)
    for m in mf.load()["per_layer"]:
        assert _reader(m["name"])(run) is None
