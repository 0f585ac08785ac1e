"""BENCHMARK.json against the contract's rules, and every file it names."""

import json
import math
import re

from port_bench.harness import Bench, check_name

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
    for w in SPEC["command"]:
        assert not w.startswith("/") and ".." not in w


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            names.append(check_name(entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        check_name(w["config"])
        check_name(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    assert len(names) == len(set(names))


def test_every_metric_reported_where_its_moves_is():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        own = [m for m in SPEC["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in SPEC["per_layer"])


def test_layers_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_files_found_by_name():
    bench = Bench(ROOT)
    for c in SPEC["configs"]:
        cfg = bench.config(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert cfg["source"] == c["source"]
        bench.family(cfg["family"])
    for w in SPEC["workloads"]:
        bench.traffic_kind(bench.traffic(w["traffic"])["kind"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_full_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    need = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(SPEC["workloads"])))
