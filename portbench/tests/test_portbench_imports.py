"""What the benchmark imports: never JAX or the JAX package (by whole
top-level name: the port's name begins with the JAX package's), and the
reference nothing of the port."""

import ast
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mvlpt_tpu"}
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "mvlpt_torch" not in set(_imported(path))
    assert "portbench" not in set(_imported(path))


def _modules_after(code):
    proc = subprocess.run([sys.executable, "-c",
                           f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
                           "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_loading_the_reference_loads_no_port():
    mods = _modules_after("from portbench.reference import clip_upt, tokenizer")
    assert "mvlpt_torch" not in mods and not mods & FORBIDDEN


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import json; from portbench import bench\n"
        "c = bench.find_cell('c100.train')\n"
        f"c.config = json.load(open({str(ROOT / 'portbench/tests/data/tiny_upt.json')!r}))\n"
        "c.traffic = {'kind': 'train_window', 'batch': 2, 'window': 2, 'pool_windows': 1,"
        " 'shots': 2, 'labels': 'uniform'}\n"
        "bench.run(c, 1, 0.1, False, device='cpu')")
    assert "mvlpt_torch" in mods
    assert not mods & FORBIDDEN
