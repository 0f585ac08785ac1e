"""A later change adds a configuration, a traffic mix and a metric as new
files and new entries, and edits no file that is there: in a temporary
copy of BENCHMARK.json and the benchmark's folder, the harness finds all
three by name and reports the new metric."""

import json
import shutil

import pytest

from port_bench.harness import run_cell

from .conftest import ROOT, SMALL_CFG, SMALL_TRAFFIC

NEW_METRIC = '''"""Volumes served in the window."""


def read(ctx):
    return float(ctx.window["attempted"])
'''


def test_new_files_only(tmp_path, small_program):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*")
              if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "port_bench/configs/aideal.json").read_text())
    cfg.update(SMALL_CFG)
    (tmp_path / "port_bench/configs/aideal_small.json").write_text(
        json.dumps(cfg))
    mix = dict(json.loads(
        (ROOT / "port_bench/traffic/study_volumes.json").read_text()),
        **dict(SMALL_TRAFFIC, volume_slices=[3, 5]))
    (tmp_path / "port_bench/traffic/short_volumes.json").write_text(
        json.dumps(mix))
    (tmp_path / "port_bench/metrics/volumes_served.py").write_text(NEW_METRIC)
    spec["configs"].append(dict(spec["configs"][0], name="aideal_small",
                                file="port_bench/configs/aideal_small.json"))
    spec["workloads"].append({"name": "aideal_small-short",
                              "config": "aideal_small",
                              "traffic": "short_volumes", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"].append({"name": "volumes_served", "unit": "volumes",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["aideal_small-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell(tmp_path, "aideal_small-short", 17, 0.5, False, "cpu")
    assert r["metrics"]["volumes_served"]["value"] == r["attempted"] > 0
    assert r["correct"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_name_outside_the_rules_is_refused(tmp_path):
    from port_bench.harness import check_name
    for bad in ("../x", "a b", "a/b", "", "x" * 65, ".hidden"):
        with pytest.raises(ValueError):
            check_name(bad)
