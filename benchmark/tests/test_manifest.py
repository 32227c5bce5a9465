import copy
import json
import os
import subprocess
import sys

from benchmark import manifest as mf

ROOT = mf.ROOT


def test_manifest_and_named_files_are_sound():
    assert mf.check(mf.load()) == []


def test_manifest_check_catches_broken_names_units_and_moves():
    bad = copy.deepcopy(mf.load())
    bad["per_layer"][0]["name"] = "has space"
    bad["per_layer"][1]["unit"] = "per second"
    bad["per_layer"][2]["moves"] = "latency_p50_ms"      # not in its cell
    bad["end_to_end"] = [m for m in bad["end_to_end"]
                         if m["name"] != "setup_s"]
    errs = "\n".join(mf.check(bad))
    assert "has space" in errs
    assert "per second" in errs
    assert "does not report latency_p50_ms" in errs
    assert "no setup_s" in errs


def test_manifest_check_finds_missing_files(tmp_path):
    bad = copy.deepcopy(mf.load())
    bad["workloads"].append(dict(bad["workloads"][0], name="x.y",
                                 traffic="nowhere"))
    errs = "\n".join(mf.check(bad))
    assert "traffic file" in errs and "limits file is missing" in errs


def test_every_cell_reports_setup_another_metric_and_a_layer():
    man = mf.load()
    for cell in man["workloads"]:
        e2e = [m["name"] for m in mf.metrics_of(man, cell["name"],
                                                "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.metrics_of(man, cell["name"], "per_layer")


def test_command_refuses_a_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cell = mf.load()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_command_fails_without_the_program(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mode0_srds.live", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_peaks_are_keyed_by_device_kind_with_a_source():
    peaks = json.load(open(os.path.join(ROOT, "benchmark", "peaks.json")))
    assert "data sheet" in peaks["source"]
    h100 = peaks["devices"]["NVIDIA H100 80GB HBM3"]
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["f32_flops_per_s"] == 67e12
