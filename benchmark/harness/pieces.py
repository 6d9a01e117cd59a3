"""Finding the benchmark's pieces by the names ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``entries/<entry>.py`` and
``metrics/<metric>.py``.  A later cell or metric adds files here and
edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return _module("entries", name)


def reader(metric: str):
    return _module("metrics", metric)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in man['workloads']]})")


def metrics_of(man: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it under ``workloads``.  Every per-layer metric
    lists its cells; an end-to-end metric without the key (``setup_s``)
    is reported by every cell."""
    if kind == "per_layer":
        return [m for m in man[kind] if cell_name in m["workloads"]]
    return [m for m in man[kind]
            if cell_name in m.get("workloads", [cell_name])]
