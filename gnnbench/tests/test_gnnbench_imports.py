"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either. Module names are compared
by their whole top-level name (``repro_torch`` begins with ``repro``)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT, SEED, SMALL

JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in (ROOT / "gnnbench").rglob("*.py"):
        assert not (_imports(path) & JAX), path


def test_reference_sources_import_nothing_of_the_port():
    for sub in ("reference", "frozen"):
        for path in (ROOT / "gnnbench" / sub).glob("*.py"):
            assert not (_imports(path) & (JAX | {"repro_torch"})), path
    for name in ("compare.py", "counts.py", "trees.py", "metrics_common.py"):
        assert not (_imports(ROOT / "gnnbench" / name) & (JAX | {"repro_torch"}))


def _loaded_after(code: str, *args: str) -> set:
    prog = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n" + code +
            "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog, str(ROOT), str(ROOT / "src"), *args],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        "from gnnbench import harness\n"
        f"harness.run_cell('sage-products.hier-int2', {SEED}, 0.2, True, device='cpu', "
        f"shrink={{'num_nodes': {SMALL}}}, log=lambda m: None)")
    assert "repro_torch" in loaded and not (loaded & JAX)


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    """The reference runs on the program's placement, handed over as plain
    arrays in a file, in a process that never loads the port."""
    import torch

    from gnnbench import harness, inputs, trees

    c = harness.cell(harness.benchmark(), "sage-products.hier-int2")
    cfg = {**c["config"], "graph": {**c["config"]["graph"], "num_nodes": SMALL}}
    raw = inputs.make_graph({**cfg["graph"], **c["traffic"]["graph"]}, 47, 100, 5)
    params = inputs.make_params(cfg["model"], 5, "cpu")
    prog = harness.load_module("programs", "sage_session").Program(
        cfg, c["traffic"], raw, trees.clone(params), inputs.Draws(5), 5, torch.device("cpu"))
    path = tmp_path / "placement.pt"
    torch.save(prog.placement(), path)
    prog.close()
    loaded = _loaded_after(
        "import torch\n"
        "from gnnbench import harness, inputs\n"
        "c = harness.cell(harness.benchmark(), 'sage-products.hier-int2')\n"
        f"cfg = {{**c['config'], 'graph': {{**c['config']['graph'], 'num_nodes': {SMALL}}}}}\n"
        "raw = inputs.make_graph({**cfg['graph'], **c['traffic']['graph']}, 47, 100, 5)\n"
        "p = inputs.make_params(cfg['model'], 5, 'cpu')\n"
        "r = harness.load_module('reference', 'sage').run(cfg, c['traffic'], raw, p, "
        "inputs.Draws(5), 5, torch.device('cpu'), placement=torch.load(sys.argv[3], "
        "weights_only=False))\n"
        "assert r['checks']['edges_off'] == 0", str(path))
    assert not (loaded & (JAX | {"repro_torch"}))
