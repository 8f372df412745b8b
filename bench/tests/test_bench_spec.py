"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, workload file, driver and metric readers by name, and the
file keeps to the contract's shapes and characters."""
import json
import re
from pathlib import Path

import pytest

from bench import harness, program

ROOT = Path(__file__).resolve().parents[2]
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BM["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(BM["end_to_end"]) <= 16
    assert 1 <= len(BM["per_layer"]) <= 128
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    # a full check with 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert len(BM["command"]) <= 32 and all(LINE.match(w)
                                            for w in BM["command"])
    for p in BM["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_names_units_and_lines():
    names = [c["name"] for c in BM["configs"]] + CELLS + [
        m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_keys_bounds_and_sources():
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BM["end_to_end"])
    e2e = {m["name"] for m in BM["end_to_end"]}
    for m in BM["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_enough(cell):
    bm, entry, wl, cfg = harness.load_cell(cell)
    assert (harness.BENCH / "drivers" / f"{wl['driver']}.py").exists()
    e2e = harness.metrics_for(bm, cell, 0)
    per_layer = harness.metrics_for(bm, cell, 1)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names, (cell, m["name"])
    for m in e2e + per_layer:
        reader = harness.load_module("metrics", m["name"])
        assert reader.read({}) is None      # finds nothing: returns nothing
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("c", BM["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME.match(key)
        assert not re.search(r"(hidden_size|intermediate_size|_dim$|_rank$|"
                             r"experts_per_tok|expansion)", key), key
        assert cfg[key] == cfg["reduced"][key][1]
    assert any(w["config"] == c["name"] for w in BM["workloads"])
    program.model_config(cfg)   # agrees with its own keys


def test_files_under_paths_are_named_from_name_characters():
    for p in BM["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_layers_are_perf_md_layers():
    perf = (ROOT / "PERF.md").read_text()
    for m in BM["per_layer"]:
        assert f"`{m['layer']}`" in perf or m["layer"] in perf, m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_served_prompts_fit_the_programs_expert_capacity(cell):
    """An expert takes at most one row a token, and the serving loop
    prefills in chunks of ``prefill_chunk`` tokens, one routing group each
    (a decode step's group is one token): where the capacity (rows an
    expert in a group) holds a whole chunk, no token is ever dropped, and
    the port's capacity routing is the configuration's dropless routing."""
    from repro_torch.models.moe import capacity
    _, _, wl, cfg = harness.load_cell(cell)
    mc = program.model_config(cfg)
    if mc.moe is None or "prefill_chunk" not in wl:
        return
    assert wl["prefill_chunk"] <= mc.moe.group_size
    assert wl["prefill_chunk"] <= capacity(mc.moe)
