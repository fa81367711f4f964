"""BENCHMARK.json and every file it names: the keys, the characters of names
and units, the lengths, and that each cell, configuration, traffic mix and
metric is found by name."""

import json
import re

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[0-9A-Za-z_][0-9A-Za-z_.-]{0,63}$")
UNIT = re.compile(r"^[0-9A-Za-z_/%.-]{1,16}$")
PATH = re.compile(r"^[0-9A-Za-z_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion)")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"].startswith("portbench/configs/")
    body = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    assert (harness.BENCH_DIR / "operators" / f"{body['operator']}.py").is_file()
    assert (harness.BENCH_DIR / "reference" / f"{body['operator']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(wl[k]) for k in ("name", "config", "traffic"))
    assert wl["chips"] == 1 and one_line(wl["why"])
    cell = harness.load_cell(wl["name"])
    assert set(cell.limits) == set(harness.NUMBERS)
    assert all(v > 0 for v in cell.limits.values())
    assert (harness.BENCH_DIR / "families" / f"{cell.traffic['family']}.py").is_file()
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    e2e = m in SPEC["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_traffic_keys_the_family_does_not_read_are_refused():
    for wl in SPEC["workloads"]:
        traffic = harness.load_cell(wl["name"]).traffic
        harness.check_traffic(wl["traffic"], traffic)
        with pytest.raises(ValueError, match="clients"):
            harness.check_traffic(wl["traffic"], {**traffic, "clients": 4})
