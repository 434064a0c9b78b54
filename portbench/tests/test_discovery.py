"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, from files added to a copy of the benchmark and entries added to
its ``BENCHMARK.json``, with no existing file of the benchmark edited."""

import hashlib
import importlib
import json
import shutil

import pytest

from portbench import run
from portbench.tests.conftest import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "ico5-b64-400.json").read_text())
    cfg["resolution"] = [200, 200]
    (pb / "configs" / "ico5-b64-200.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "side.json").write_text(json.dumps(
        {"pool": 4, "gt": {"rotation": 30.0, "z": -3.0}, "init": {"degrees": 2.0,
                                                              "translation": 0.01}}))
    (pb / "metrics" / "frames_in_pool.py").write_text(
        'LAYER = "traffic"\nSOURCE = "program_counter"\nUNIT = "count"\nBETTER = "higher"\n'
        'MOVES = "refinements_per_s"\nWORKLOADS = ["ico5-b64-200.side"]\n\n\n'
        'def read(run):\n    return float(len(run.records))\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ico5-b64-200", "source": "https://example.org",
                             "file": "portbench/configs/ico5-b64-200.json",
                             "reduced": ["mesh"], "why": "a test"})
    bench["workloads"].append({"name": "ico5-b64-200.side", "config": "ico5-b64-200",
                               "traffic": "side", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_in_pool", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "traffic",
                               "moves": "refinements_per_s",
                               "workloads": ["ico5-b64-200.side"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added

    plan = run.cell_plan(json.loads((tmp_path / "BENCHMARK.json").read_text()),
                         "ico5-b64-200.side", root=tmp_path)
    assert plan["config"]["resolution"] == [200, 200]
    assert plan["mix"]["gt"]["z"] == -3.0
    assert [m["name"] for m in plan["per_layer"]] == ["frames_in_pool"]
    assert {m["name"] for m in plan["end_to_end"]} == {"refinements_per_s", "add_auc",
                                                       "setup_s"}
    reader = run.metric_reader("frames_in_pool", root=tmp_path)

    class View:
        records = [1, 2, 3]

    assert reader.read(View()) == 3.0


def test_every_metric_file_declares_what_benchmark_json_says():
    bench = run.load_benchmark()
    for m in bench["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.BETTER, mod.MOVES) == (
            m["layer"], m["source"], m["unit"], m["better"], m["moves"]), m["name"]
        assert mod.WORKLOADS == m["workloads"], m["name"]
        assert all(w in {c["name"] for c in bench["workloads"]} for w in m["workloads"])


def test_every_cell_has_its_files():
    bench = run.load_benchmark()
    for w in bench["workloads"]:
        plan = run.cell_plan(bench, w["name"])
        assert plan["limits"] is not None, w["name"]
        assert set(plan["limits"]) == {"loss_gap", "pose_gap", "kept_gap"}
        assert plan["per_layer"] and plan["end_to_end"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        run.cell_plan(run.load_benchmark(), "no-such.cell")
