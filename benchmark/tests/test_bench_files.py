"""BENCHMARK.json against the benchmark's contract, and every entry found
by its name: configurations and their world makers, traffic mixes and
their drivers, metric readers; a cell of a new mix and driver runs with
no edit to a file that is there."""
import importlib.util
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|head"
                   r"|expansion|experts_per_tok|projection")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_one_line_texts(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + metrics:
        assert NAME.match(n), n
    assert len(set(metrics)) == len(metrics)
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == \
        len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    texts = [w["why"] for w in bench["workloads"]]
    texts += [c["why"] for c in bench["configs"]]
    texts += [c["source"] for c in bench["configs"]]
    texts += [m["layer"] for m in bench["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_configs_resolve(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in conf and key in conf["reduced"], key
        assert conf["source"] and conf["assumed"]
        maker = conf["world"]["maker"]
        assert NAME.match(maker)
        assert os.path.isfile(os.path.join(BENCH, "worlds", maker + ".py"))


def test_workloads_resolve(bench):
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        path = os.path.join(BENCH, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            traffic = json.load(f)
        driver = os.path.join(BENCH, "drivers", traffic["driver"] + ".py")
        assert NAME.match(traffic["driver"]) and os.path.isfile(driver)
        assert traffic["limits"]
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics_resolve_and_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reported & cells, m["name"]
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads",
                                                          cells)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell


def test_a_new_driver_and_world_are_found_by_name(tmp_path, monkeypatch):
    """A driver and a world maker that no file of the harness names are
    loaded from their own files by the names a mix and a configuration
    give."""
    from harness import common

    for kind, name in (("drivers", "zz_probe_driver"),
                       ("worlds", "zz_probe_world")):
        path = os.path.join(BENCH, kind, name + ".py")
        assert not os.path.exists(path)
        try:
            with open(path, "w") as f:
                f.write("def run(ctx):\n    ctx.ran = True\n"
                        "def make(cfg, seed_seq, root):\n    return root\n")
            mod = common.load_module(kind, name)
        finally:
            os.remove(path)
        assert callable(mod.run) and mod.make(None, None, "r") == "r"
