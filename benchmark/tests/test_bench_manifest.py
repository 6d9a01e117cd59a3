"""BENCHMARK.json against the contract's rules, and the harness finding
every piece it names."""

import json
import re

import pytest

from benchmark.harness import pieces

MAN = pieces.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((pieces.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (pieces.ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_end_to_end_bounds():
    by = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in by and by["setup_s"]["bound"] <= 0.25
    for m in by.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for c in CELLS:
        e2e = {m["name"] for m in pieces.metrics_of(MAN, c, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, c
        assert pieces.metrics_of(MAN, c, "per_layer"), c


def test_every_per_layer_metric_lists_its_cells():
    for m in MAN["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m
    for m in MAN["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m


def test_moves_target_is_reported_by_each_cell_of_the_metric():
    for m in MAN["per_layer"]:
        for c in m["workloads"]:
            e2e = {x["name"] for x in pieces.metrics_of(MAN, c, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], c)
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)


def test_every_configuration_keeps_a_cell_and_a_file_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(MAN["paths"][0] + "/")
        cfg = json.loads((pieces.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


def test_four_chip_cells_within_the_share():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_every_piece_by_name(cell):
    w = pieces.cell(MAN, cell)
    assert pieces.config(w["config"])["name"] == w["config"]
    tr = pieces.traffic(w["traffic"])
    entry = pieces.entry(tr["entry"])
    for fn in ("prepare", "call", "reference", "gaps"):
        assert callable(getattr(entry, fn)), fn
    limits = pieces.limits(cell)
    assert limits and all("limit" in v for v in limits.values())
    for kind in ("end_to_end", "per_layer"):
        for m in pieces.metrics_of(MAN, cell, kind):
            assert callable(pieces.reader(m["name"]).read), m["name"]


def test_missing_pieces_are_named():
    with pytest.raises(KeyError, match="no workload"):
        pieces.cell(MAN, "no_such_cell")
    with pytest.raises(FileNotFoundError, match="traffic"):
        pieces.traffic("no_such_traffic")
