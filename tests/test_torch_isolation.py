"""The port stands on its own: no module of gaml_tpu_torch, and neither
chip_smoke.py nor chip_ab.py, imports gaml_tpu or jax; a process that imports every port
module and runs the port's CLI holds neither in sys.modules; and every
public entry point that takes a device runs on the card unless the caller
asks for the CPU."""
import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import torch

import gaml_tpu_torch

from test_torch_cli import REPO, write_world
from test_torch_kernels import port_native_lib

PORT = os.path.join(REPO, "gaml_tpu_torch")


def port_sources():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py", "chip_ab.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gaml_tpu_torch.__path__, "gaml_tpu_torch."))


def foreign(name):
    top = name.split(".")[0]
    return top in ("gaml_tpu", "jax", "jaxlib")


def test_no_port_source_imports_gaml_tpu_or_jax():
    """An AST scan: every import statement, at any depth, of every port
    source and of the card scripts."""
    bad = []
    files = port_sources()
    assert len(files) > 50
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if foreign(n)]
    assert not bad, bad


def test_port_process_holds_neither_jax_nor_gaml_tpu(tmp_path):
    """Every port module imported, then the CLI on a tiny config on the
    CPU (device backend, every batch on the device path), in a fresh
    process."""
    assert port_native_lib() is not None
    config = write_world(tmp_path, iterations=3)("iso")
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from gaml_tpu_torch.cli import main\n"
        f"assert main([{config!r}, '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'gaml_tpu'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    env = dict(os.environ, GAML_DEV_MIN_BASES="0")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ISOLATED"
    assert '"batches": 0' not in proc.stdout


def test_bfs_route_loads_no_torch(tmp_path):
    """--backend bfs --device cpu runs on the host layers alone, as
    gaml_tpu.cli --backend bfs does: torch and the device modules never
    load (importing torch takes seconds)."""
    assert port_native_lib() is not None
    config = write_world(tmp_path, iterations=3)("bfs")
    code = (
        "import sys\n"
        "from gaml_tpu_torch.cli import main\n"
        f"assert main([{config!r}, '--backend', 'bfs', '--device', 'cpu'])"
        " == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'gaml_tpu'))\n"
        "assert not bad, bad\n"
        "print('HOST ONLY')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "HOST ONLY"


def device_defaults():
    """(qualified name, default) of every ``device`` parameter with a
    default among the public functions, classes and methods the port's
    modules define, read from their signatures."""
    out = []
    for name in port_modules():
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) \
                    != name:
                continue
            funcs = [(attr, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                funcs += [(f"{attr}.{k}", v) for k, v in vars(obj).items()
                          if inspect.isfunction(v)
                          and (k == "__init__" or not k.startswith("_"))]
            for qual, fn in funcs:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not p.empty:
                    out.append((f"{name}.{qual}", p.default))
    return out


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    found = device_defaults()
    names = {q.rsplit(".", 2)[-2] if q.endswith("__init__")
             else q.rsplit(".", 1)[-1] for q, _ in found}
    for entry in ("SubpathAligner", "ReadSet", "PacbioReadSet",
                  "prepare_read_sets", "DeviceCandGen", "DeviceExtender",
                  "DeviceRescorer", "LikelihoodModel", "from_params",
                  "batch_extend_multi", "stage_candidates"):
        assert entry in names, (entry, sorted(names))
    assert [(q, d) for q, d in found if d != "cuda"] == []
    # the CLI: without --device it asks for the card, and without one it
    # refuses instead of running on the CPU
    from gaml_tpu_torch.cli import main

    config = write_world(tmp_path, iterations=1)("card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([config]) == 2
    assert main([config, "--backend", "bfs"]) == 2
