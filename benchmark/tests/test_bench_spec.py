"""BENCHMARK.json keeps to the contract's shape, and the harness finds
cells, configurations and per-layer metrics from files alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[kind]:
            yield kind, entry


def _id(x):
    return x["name"] if isinstance(x, dict) else x


@pytest.mark.parametrize("kind,entry", list(_names()), ids=_id)
def test_names_units_and_keys(kind, entry):
    assert NAME.match(entry["name"])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(entry) - {"workloads"} == METRIC_KEYS | extra
    if kind == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if kind == "per_layer":
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (BENCH / "metrics" / f"{entry['name']}.py").is_file()
        if "roofline" in entry["name"] or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if kind == "workloads":
        assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
        assert (BENCH / "workloads" / f"{entry['name']}.json").is_file()
        wl = json.loads((BENCH / "workloads" / f"{entry['name']}.json").read_text())
        assert wl["config"] == entry["config"]
    if kind == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / entry["file"]).is_file() and entry["file"].startswith("benchmark/")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in {e["name"] for e in e2e}


def test_a_dummy_cell_and_metric_from_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((BENCH / "workloads" / "lamno3_1x1_rigid.json").read_text())
    (tmp_path / "benchmark" / "workloads" / "dummy_cell.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark" / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["workloads"].append({"name": "dummy_cell", "config": "lamno3_chgnet",
                              "traffic": "dummy", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "kernels",
                              "moves": "evals_per_s", "workloads": ["dummy_cell"]})
    spec["end_to_end"][0]["workloads"].append("dummy_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from benchmark import harness as h; "
            "print('dummy_cell' in h.listed_cells(), "
            "[m['name'] for m in h.metrics_of('dummy_cell', 'per_layer')], "
            "h.metric_reader('dummy_metric')({}), h.load_workload('dummy_cell')['config'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out[0] == "True" and "'dummy_metric']" in " ".join(out) and "42.0" in out


def test_no_result_without_the_port(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lamno3_1x1_rigid",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_a_card():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lamno3_1x1_rigid",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                            "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
