"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
gaml_tpu, by top-level module name compared whole (gaml_tpu_torch, the
port, begins with gaml_tpu); the plain reference imports nothing of the
port either."""
import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FOREIGN = {"jax", "jaxlib", "flax", "gaml_tpu"}


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def sources(sub=""):
    for root, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(root, f) for f in files
                    if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    bad = [(p, n) for p in sources() for n in imports(p)
           if n.split(".")[0] in FOREIGN]
    assert not bad, bad
    assert len(list(sources())) > 15


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p, n) for p in sources("reference") for n in imports(p)
           if n.split(".")[0] in FOREIGN | {"gaml_tpu_torch"}]
    assert not bad, bad


def test_whole_names_are_compared():
    from harness import common

    saved = dict(sys.modules)
    try:
        for name in [m for m in sys.modules if m.split(".")[0] in FOREIGN]:
            del sys.modules[name]
        sys.modules["gaml_tpu_torch_x"] = sys
        assert common.foreign_modules() == []
        sys.modules["gaml_tpu.core"] = sys
        assert common.foreign_modules() == ["gaml_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_holds_no_foreign_module():
    """A whole CPU run of each cell in a fresh process: it exits 0 (the
    run's own check would exit 4) and its process holds the port but no
    module of jax or the JAX package."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_small\n"
        "for cell in ('aureus.rescore', 'aureus.anneal'):\n"
        "    rc, res = run_small(cell)\n"
        "    assert rc == 0 and res['correct'], (cell, rc, res)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(' '.join(tops))\n"
    ) % (os.path.join(BENCH, "tests"), BENCH)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert "gaml_tpu_torch" in tops
    assert not tops & FOREIGN
