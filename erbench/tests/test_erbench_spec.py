"""``BENCHMARK.json`` against its contract and the files it names: every
configuration, traffic mix, limit file and metric reader is found by
name, and every name, unit and text keeps to its characters."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
KINDS = {p.stem for p in (ROOT / "erbench" / "drivers").glob("*.py")
         if p.stem != "__init__"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _cells():
    return BENCH["workloads"]


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert _text(c["source"]) and _text(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in _cells():
        assert _text(w["why"]) and NAME.match(w["traffic"])
    for m in BENCH["per_layer"]:
        assert _text(m["layer"])


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in _cells():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_configs_are_files_of_their_own_and_each_is_used():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in _cells()}
    for c in BENCH["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert path == ROOT / "erbench" / "configs" / f"{c['name']}.json"
        body = json.loads(path.read_text())
        assert body["name"] == c["name"]
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_cells_find_their_files_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in _cells():
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "erbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert mix["kind"] in KINDS
        limits = json.loads((ROOT / "erbench" / "limits"
                             / f"{w['name']}.json").read_text())
        assert set(limits) == {"blocked_diff", "matched_diff"}
    fours = sum(w["chips"] == 4 for w in _cells())
    assert fours <= max(1, len(_cells()) // 4)


def test_every_metric_has_a_reader():
    for m in _metrics():
        path = ROOT / "erbench" / "metrics" / f"{m['name']}.py"
        assert path.is_file(), path
        assert "def read(" in path.read_text()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in _cells():
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        layer = [m for m in BENCH["per_layer"]
                 if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(m):
    cells = {w["name"] for w in _cells()}
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    mine = m.get("workloads", sorted(cells))
    assert mine and set(mine) <= cells
    target = e2e[m["moves"]]
    for cell in mine:
        assert "workloads" not in target or cell in target["workloads"]


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert layer == layer.strip() and "  " not in layer
    lower = {x.lower() for x in layers}
    assert len(lower) == len(layers)


def test_roofline_shares_are_named_for_their_kernel():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["source"] == "device_trace"
            assert m["name"].split(".")[0].endswith("_roofline")
