"""BENCHMARK.json against the contract's form, every name resolved to a
file, and the imports of the benchmark's sources."""

import ast
import json
import os
import re

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
DIR = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mtn_tpu"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_name_resolves_to_a_file():
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert json.load(open(path))["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        mix = json.load(open(os.path.join(DIR, "traffic",
                                          w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(DIR, "drivers",
                                           mix["driver"] + ".py"))
        assert os.path.exists(os.path.join(DIR, "limits",
                                           w["name"] + ".json"))
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(DIR, "metrics",
                                           m["name"] + ".py")), m["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    for d, _, files in os.walk(DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "math", "typing", "torch"}, tops
