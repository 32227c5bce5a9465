"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, client driver,
metric or cell is a file of its own, found here by the name the manifest
gives:

  configs/<config>.json       (the `file` of the configuration entry)
  traffic/<traffic>.json      the mix: loop kind, sizes, schedule, limits
  drivers/<loop>_loop.py      the client loop the mix names
  metrics/<metric>.py         one reader per metric, end-to-end or per layer
  limits/<workload>.json      the limits of the numbers `correct` compares

so a cell is added by adding files and a `workloads` entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


class ManifestError(ValueError):
    pass


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json; have "
                        f"{[w['name'] for w in manifest['workloads']]}")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise ManifestError(f"no configuration {name!r} in BENCHMARK.json")


def config(manifest: dict, cell: dict, root: str = ROOT) -> dict:
    return _json(os.path.join(root, config_entry(manifest, cell["config"])
                              ["file"]))


def traffic(cell: dict, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))


def limits(cell: dict, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "limits", f"{cell['name']}.json"))


def driver_path(mix: dict, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "drivers", f"{mix['loop']}_loop.py")


def metric_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "metrics", f"{name}.py")


def load_module(path: str):
    """Import a file by path (names may hold dots)."""
    mod_name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def check(manifest: dict, root: str = ROOT) -> list[str]:
    """Problems with the manifest and the files it names (empty = sound)."""
    bench_dir = os.path.join(root, "benchmark")
    errs: list[str] = []
    names: set[str] = set()

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME_RE.match(n):
            errs.append(f"{what} name {n!r} breaks the name rule")

    for c in manifest.get("configs", []):
        name_ok(c["name"], "configuration")
        for k in c.get("reduced", []):
            name_ok(k, "reduced key")
        if not os.path.isfile(os.path.join(root, c["file"])):
            errs.append(f"configuration file {c['file']} is missing")
    cells = {w["name"]: w for w in manifest.get("workloads", [])}
    config_names = {c["name"] for c in manifest.get("configs", [])}
    for w in cells.values():
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        if w["config"] not in config_names:
            errs.append(f"{w['name']}: unknown configuration {w['config']}")
        mix_path = os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")
        if not os.path.isfile(mix_path):
            errs.append(f"{w['name']}: traffic file {mix_path} is missing")
        else:
            drv = driver_path(_json(mix_path), bench_dir)
            if not os.path.isfile(drv):
                errs.append(f"{w['name']}: driver {drv} is missing")
        if not os.path.isfile(os.path.join(bench_dir, "limits",
                                           f"{w['name']}.json")):
            errs.append(f"{w['name']}: limits file is missing")
    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    if "setup_s" not in e2e:
        errs.append("no setup_s end-to-end metric")
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.get(kind, []):
            name_ok(m["name"], "metric")
            if m["name"] in names:
                errs.append(f"metric {m['name']} appears twice")
            names.add(m["name"])
            if not UNIT_RE.match(m.get("unit", "")):
                errs.append(f"{m['name']}: unit {m.get('unit')!r} breaks "
                            f"the unit rule")
            if m.get("better") not in ("lower", "higher"):
                errs.append(f"{m['name']}: better must be lower or higher")
            allowed = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if m.get("source") not in allowed:
                errs.append(f"{m['name']}: source {m.get('source')!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    errs.append(f"{m['name']}: unknown workload {c}")
            if not os.path.isfile(metric_path(m["name"], bench_dir)):
                errs.append(f"{m['name']}: reader "
                            f"{metric_path(m['name'], bench_dir)} is missing")
    for m in manifest.get("per_layer", []):
        target = e2e.get(m.get("moves"))
        if target is None:
            errs.append(f"{m['name']}: moves {m.get('moves')!r}, which is "
                        f"no end-to-end metric")
            continue
        for c in m.get("workloads", list(cells)):
            if "workloads" in target and c not in target["workloads"]:
                errs.append(f"{m['name']}: cell {c} does not report "
                            f"{target['name']}, the metric it moves")
    for c in cells:
        kinds = [metrics_of(manifest, c, "end_to_end"),
                 metrics_of(manifest, c, "per_layer")]
        if len(kinds[0]) < 2 or not kinds[1]:
            errs.append(f"{c}: needs setup_s, another end-to-end metric and "
                        f"a per-layer metric")
    return errs
