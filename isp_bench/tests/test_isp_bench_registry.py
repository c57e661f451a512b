"""The harness is driven by data: a cell, a configuration, a traffic mix and
a metric added as new files (and entries in BENCHMARK.json) are found by name
with no edit to a file that is there; and every name and unit of
BENCHMARK.json keeps to the characters the contract allows."""
import json
import re
import shutil
from pathlib import Path

from isp_bench.tests import helpers

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_added_as_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "isp_bench", root / "isp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "isp_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "isp_bench"
    conf = json.loads((here / "configs" / "cam24.json").read_text())
    (here / "configs" / "cam12.json").write_text(json.dumps({**conf, "name": "cam12"}))
    (here / "traffic" / "fast_only.json").write_text(json.dumps(
        {"driver": "resident", "entry": "develop", "inputs": 2, "mix": [["fast", 1.0]]}))
    (here / "checks" / "cam12.fast.json").write_text(json.dumps(
        {"limits": {"max_abs": 1e-4, "rms": 1e-5}}))
    (here / "metrics" / "items_done.py").write_text(
        "def read(run):\n    return float(len(run.items))\n")
    bench["configs"].append({"name": "cam12", "source": "x", "file": "isp_bench/configs/cam12.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "cam12.fast", "config": "cam12", "traffic": "fast_only",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "items_done", "unit": "items", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["cam12.fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, ctx = helpers.run_cell("cam12.fast", root=root)
    assert ctx.traffic["mix"] == [["fast", 1.0]]
    assert result["correct"], result["checks"]
    assert result["metrics"]["items_done"]["value"] == result["attempted"] > 0
    assert set(result["metrics"]) == {"items_done", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_names_and_units_use_only_the_allowed_characters():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "isp_bench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        assert (ROOT / "isp_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "isp_bench" / "checks" / f"{w['name']}.json").exists()
    for text in [c["source"] for c in bench["configs"]] + [x["why"] for x in bench["configs"]
                                                           + bench["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
