"""Run one benchmark cell once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration file and a
traffic mix; the mix names its client loop.  Set-up builds the program's
receiver on the configuration's engine set, the seeded traffic pool, and
warms the step's one shape; then the client loop drives the served path
for `--seconds` (u8 batch to the card, `jax.jit(Receiver.step)`, every
output back to the host).  After the window the sampled stations' outputs
are compared with the plain reference (benchmark/reference.py) block by
block, each number against its limit in limits/<cell>.json.

With --trace 0 the result carries the cell's end-to-end metrics; with
--trace 1 a stretch of the window is traced with jax.profiler and the
result carries the per-layer metrics and a breakdown of the trace.

On anything but an NVIDIA GPU (or with fewer cards than the cell asks
for) it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import manifest as mf  # noqa: E402

EXIT_NO_CHIP = 3


class NoChip(RuntimeError):
    pass


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Smi:
    """Samples the card's clocks, power and temperature with nvidia-smi
    every 500 ms in a child process that stays off JAX."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self.rows: list[list[float]] = []
        self.proc = None
        self.thread = None

    def start(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue

    def stop(self) -> str:
        if self.proc is None:
            return "nvidia-smi: not available"
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)
        if not self.rows:
            return "nvidia-smi: no samples"
        a = np.asarray(self.rows)
        names = self.QUERY.split(",")
        return "nvidia-smi over the window (min/median/max): " + ", ".join(
            f"{n} {a[:, i].min():g}/{np.median(a[:, i]):g}/{a[:, i].max():g}"
            for i, n in enumerate(names)) + f" ({len(a)} samples)"


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    setup_s: float
    records: list
    drive: dict
    stations: int
    step_seconds: float
    step_iq: int
    config: dict
    peak: dict | None
    trace: object | None
    notes: list


def sample_rows(seed: int, stations: int, count: int) -> np.ndarray:
    """Stations compared with the reference: the first and the last, and
    the rest drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    count = min(count, stations)
    middle = rng.choice(np.arange(1, stations - 1), size=max(count - 2, 0),
                        replace=False) if stations > 2 else []
    return np.unique(np.concatenate([[0, stations - 1], middle]).astype(int))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             require_chip: bool = True, overrides: dict | None = None,
             step_wrapper=None, control: bool = False) -> dict:
    """One run of one cell; returns the result object (see main)."""
    man = mf.load()
    cell = mf.workload(man, name)
    cfg = mf.config(man, cell)
    mix = dict(mf.traffic(cell), **(overrides or {}))
    limits = mf.limits(cell)
    import jax
    devs = jax.devices()
    if require_chip and (devs[0].platform != "gpu"
                         or len(devs) < int(cell["chips"])):
        raise NoChip(f"cell {name} needs {cell['chips']} GPU(s); JAX has "
                     f"{devs}")
    import sdr_tpu
    if not os.path.abspath(sdr_tpu.__file__).startswith(ROOT + os.sep):
        raise ImportError(f"sdr_tpu comes from {sdr_tpu.__file__}, not from "
                          f"this checkout")
    from sdr_tpu import device
    from sdr_tpu.cli import describe_engines, fast_engines
    from sdr_tpu.models.receiver import Receiver

    from benchmark import trace as tr
    from benchmark.client import Session, Tracer
    from benchmark.correct import block_errors, decide
    from benchmark.gen.captures import build_pool
    from benchmark.reference import ReferenceReceiver, segment_blocks

    cache = device.init_compile_cache()
    m, ch = cfg["mode"], cfg["chain"]
    engines = fast_engines() if ch["engines"] == "fast" else {}
    rx = Receiver(m["number"], stereo=ch["stereo"], rds=ch["rds"], **engines)
    stations = int(mix.get("stations", cfg["stations"]))
    step_bytes = rx.block_size_u8(int(mix["blocks_per_step"]))
    step_iq = step_bytes // 2
    mix["step_seconds"] = step_iq / m["rf_fs"]
    log(f"cell {name}: {cfg['name']} x {cell['traffic']} ({mix['loop']} "
        f"loop), {stations} stations, {mix['step_seconds'] * 1e3:g} ms of "
        f"signal per step, {describe_engines(rx)}; seed {seed}; compile "
        f"cache {cache}")
    t = time.perf_counter()
    pool = build_pool(seed, stations, step_bytes, int(mix["pool_steps"]),
                      int(mix["distinct_captures"]))
    log(f"pool: {pool.data.shape[0]} steps x {stations} stations x "
        f"{step_bytes} B = {pool.data.nbytes} B of host memory, period "
        f"{pool.data.shape[0] * mix['step_seconds']:g} s of signal, "
        f"{len(pool.meta)} distinct captures, built in "
        f"{time.perf_counter() - t:.3f} s")

    step = jax.jit(rx.step)
    if step_wrapper is not None:
        step = step_wrapper(rx, step)
    state = rx.init_state((stations,))
    for k in range(int(mix["warmup_steps"])):
        state, out = step(state, jax.device_put(pool.block(k)))
        jax.device_get(out)
    del state, out
    rows = sample_rows(seed, stations, int(mix["check_stations"]))
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_") if trace else None
    tracer = Tracer(trace_dir, 0.3 * seconds, min(3.0, 0.4 * seconds))
    session = Session(step, rx.init_state((stations,)), pool, rows, tracer)
    driver = mf.load_module(mf.driver_path(mix))
    compiles = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, dur, **kw: compiles.append(ev) if "compile" in ev
        else None)
    setup_s = time.perf_counter() - T_START

    smi = Smi().start()
    n_before = len(compiles)
    pauses: list[float] = []
    gc_clock = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_clock[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - gc_clock[0])

    gc.callbacks.append(on_gc)
    try:
        drive = driver.drive(session, mix, seconds)
    finally:
        gc.callbacks.remove(on_gc)
    bad = session.close()
    log(f"garbage collections in the window: {len(pauses)}, longest "
        f"{max(pauses, default=0.0) * 1e3:.3f} ms, total "
        f"{sum(pauses) * 1e3:.3f} ms")
    in_window = len(compiles) - n_before
    log(smi.stop())
    dev = devs[0]
    stats = dev.memory_stats() or {}
    memory_peak = int(stats.get("peak_bytes_in_use", 0))
    served_steps = len(session.records)
    attempted = drive["blocks"] * stations
    failed = bad + drive["unsent"] * stations
    log(f"window: {served_steps} steps served of {drive['blocks']}, "
        f"{attempted} station-blocks attempted, {failed} failed "
        f"({bad} not finite, {drive['unsent'] * stations} never sent); "
        f"{in_window} compile events inside the window; device memory "
        f"peak {memory_peak} B")
    _log_schedule(session.records, mix)

    # ---- correctness, after the window and with the program's state freed
    served = {k: np.stack(v, axis=1) for k, v in session.kept.items()}
    session.state = None
    seg = segment_blocks(served_steps, mix["step_seconds"])
    p = pool.data.shape[0]

    def segments():
        for k0 in range(0, served_steps, seg):
            yield np.concatenate([pool.data[(k0 + j) % p][rows]
                                  for j in range(seg)], axis=-1)

    t = time.perf_counter()
    ref_out = ReferenceReceiver(cfg).run(segments(), len(rows))
    checks = block_errors(served, ref_out)
    correct = decide(checks, limits)
    log(f"reference: {len(rows)} stations x {served_steps} steps compared "
        f"in {time.perf_counter() - t:.1f} s (stations {rows.tolist()})")
    control_checks = None
    if control:
        ctl = ReferenceReceiver(cfg, "control").run(segments(), len(rows))
        shaped = {k: v.reshape(len(rows), served_steps, -1)
                  for k, v in ctl.items()}
        control_checks = block_errors(shaped, ref_out)

    # ---- metrics
    td = None
    notes: list[str] = []
    if trace:
        scopes = tr.hlo_scopes(step.lower(
            rx.init_state((stations,)),
            jax.ShapeDtypeStruct((stations, step_bytes), np.uint8)
        ).compile().as_text()) if step_wrapper is None else {}
        try:
            td = tr.read(trace_dir, scopes)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
    with open(os.path.join(BENCH_DIR, "peaks.json")) as f:
        peak = json.load(f)["devices"].get(dev.device_kind)
    if require_chip and peak is None:
        raise KeyError(f"no peaks for device kind {dev.device_kind!r} in "
                       f"benchmark/peaks.json")
    run = RunRecord(setup_s, session.records, drive, stations,
                    mix["step_seconds"], step_iq, cfg, peak, td, notes)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for md in mf.metrics_of(man, name, kind):
        v = mf.load_module(mf.metric_path(md["name"])).read(run)
        if v is not None:
            metrics[md["name"]] = {"value": float(v), "unit": md["unit"]}
    for n in notes:
        log(n + f" (card: {device.gpu_info()})")
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(devs),
                         "memory_peak_bytes": memory_peak}}
    if td is not None:
        result["device"]["busy_s"] = td.busy_s()
        result["device"]["window_s"] = td.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(td),
                               "idle_gaps": tr.idle_gaps(td)}
        log(f"trace: {td.steps} steps in {td.window_s:.6f} s, "
            f"{len(td.kernels)} kernels, {len(td.copies)} copies")
    if control_checks is not None:
        result["control_checks"] = control_checks
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in checks.items()}
    return result


def _log_schedule(records, mix):
    """Lateness of the open loop and blocks over the latency limit."""
    from benchmark.client import latencies_ms
    due = [r for r in records if r.due is not None and r.done is not None]
    if not due:
        return
    lat = latencies_ms(due)
    late = np.asarray([r.dispatched - r.due for r in due]) * 1e3
    for i in np.argsort(-lat)[:5]:
        r = due[i]
        log(f"  slow block {r.k}: latency {lat[i]:.4f} ms = late "
            f"{(r.put - r.due) * 1e3:.4f} + put "
            f"{(r.dispatched - r.put) * 1e3:.4f} + dispatch "
            f"{(r.returned - r.dispatched) * 1e3:.4f} + until fetch "
            f"{(r.fetch - r.returned) * 1e3:.4f} + fetch "
            f"{(r.done - r.fetch) * 1e3:.4f}")
    tenth = max(1, len(lat) // 10)
    limit = float(mix["latency_limit_ms"])
    log(f"latency ms p50 {np.percentile(lat, 50):.4f} p90 "
        f"{np.percentile(lat, 90):.4f} p95 {np.percentile(lat, 95):.4f} p99 "
        f"{np.percentile(lat, 99):.4f} max {lat.max():.4f} over "
        f"{len(lat)} blocks; {int((lat > limit).sum())} blocks over the "
        f"{limit:g} ms limit; dispatch lateness ms p50 "
        f"{np.percentile(late, 50):.4f} p99 {np.percentile(late, 99):.4f}; "
        f"mean latency first tenth {lat[:tenth].mean():.4f} last tenth "
        f"{lat[-tenth:].mean():.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except NoChip as e:
        log(f"no result: {e}")
        return EXIT_NO_CHIP
    for k, c in res["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
