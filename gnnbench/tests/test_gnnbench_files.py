"""The harness finds every configuration, traffic mix, limit, program entry,
reference and metric by its name, and picks up new ones with no edit."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, SMALL
from gnnbench import harness


def test_every_named_file_loads():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        c = harness.cell(bench, w["name"])
        assert c["config"]["name"] == w["config"]
        exact = {"edges_off"} if c["config"]["reference"] == "sage" else set()
        assert set(c["limits"]) == {"loss1_gap", "loss_gap", "grad_gap", "grad_gap_median",
                                    "change_gap", "change_gap_median"} | exact
        assert all(c["limits"][k] == 0 for k in exact)
        assert hasattr(harness.load_module("programs", c["config"]["program"]), "Program")
        assert hasattr(harness.load_module("reference", c["config"]["reference"]), "run")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_cell_metrics_follow_the_workloads_key():
    bench = harness.benchmark()
    names = lambda cell, trace: [m["name"] for m in harness.cell_metrics(bench, cell, trace)]
    assert names("gat-arxiv.full-batch", False) == ["epoch_ms", "peak_mem_gib", "setup_s"]
    assert "quant_pack_roofline" in names("sage-products.hier-int2", True)
    assert "quant_pack_roofline" not in names("sage-products.flat-fp32", True)
    assert "partition_s" not in names("gat-arxiv.full-batch", True)


NEW_METRIC = '''"""edges_seen: the graph's aggregated edges (a test metric)."""

from gnnbench import counts


def read(ctx):
    return float(counts.edges(ctx["raw"]))
'''


def test_new_files_are_picked_up(tmp_path):
    """A new traffic mix, its limits and a new per-layer metric, added as
    files and named in BENCHMARK.json, run with no other edit."""
    shutil.copytree(ROOT / "gnnbench", tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "gnnbench/workloads/hier-int2.json").read_text())
    traffic["schedule"]["inter_cd"] = 3
    (tmp_path / "gnnbench/workloads/hier-int2.cd3.json").write_text(json.dumps(traffic))
    (tmp_path / "gnnbench/limits/sage-products.hier-int2.cd3.json").write_text(
        json.dumps({k: None for k in ("loss1_gap", "loss_gap", "grad_gap", "grad_gap_median", "change_gap", "change_gap_median")}))
    (tmp_path / "gnnbench/metrics/edges_seen.py").write_text(NEW_METRIC)
    bench["workloads"].append({"name": "sage-products.hier-int2.cd3", "config": "sage-products",
                               "traffic": "hier-int2.cd3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "edges_seen", "unit": "edges", "better": "higher",
                               "source": "program_counter", "layer": "Device",
                               "moves": "epoch_ms", "workloads": ["sage-products.hier-int2.cd3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from gnnbench import harness\n"
            f"r = harness.run_cell('sage-products.hier-int2.cd3', {SEED}, 0.5, True, "
            f"device='cpu', shrink={{'num_nodes': {SMALL}}}, log=lambda m: None)\n"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT / "src")],
                         capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["metrics"]["edges_seen"]["value"] > SMALL
    assert r["attempted"] % 3 == 0          # whole periods of the new schedule


def test_cli_without_a_card_prints_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          "sage-products.hier-int2", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_cli_without_the_program_prints_no_result(tmp_path):
    """A checkout of nothing but BENCHMARK.json and gnnbench/ fails."""
    shutil.copytree(ROOT / "gnnbench", tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          "sage-products.hier-int2", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_cli_on_the_card(card):
    out = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                          "gat-arxiv.full-batch", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
