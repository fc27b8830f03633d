"""BENCHMARK.json against the benchmark's contract, the frozen corpus
generators against the port's digests, and the imports of the harness."""

from __future__ import annotations

import ast
import hashlib
import os
import re

import pytest

from helpers_portbench import bench
from portbench.run import HERE, ROOT, metric_reader, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the first 15,999,967 bytes (16 MB, cut after a newline) of the 1 GB
# corpus that the port's bench.make_big_corpus writes at its seed 99
HEAPS16_SHA256 = ("0169b93598a77d10a3dd4f15ae52e6d9"
                  "3653a17932e916a8d5bfea02c4acc75f")
FORBIDDEN = {"jax", "jaxlib", "flax", "shredword_tpu", "bench"}
JAX_DIR = "shredword_tpu" + "/"     # the JAX package's folder, read by none
# modules of the yardstick: they import nothing of the program
YARDSTICK = ("reference.py", "compare.py", "roofline.py", "trace.py",
             "control.py", "generators")


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(b["configs"]) <= 24
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_units_and_entry_keys():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer",
                                                            "moves"}
            assert set(m) - {"workloads"} == keys
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for text in [c["source"] for c in b["configs"]] + [
            w["why"] for w in b["workloads"]] + [
            m["layer"] for m in b["per_layer"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_bounds():
    e2e = {m["name"]: m for m in bench()["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    # Set-up is reported by every cell, those that later PRs add too.
    assert "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_move():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]

    def reported(m):
        return m.get("workloads", cells)

    e2e = {m["name"]: m for m in b["end_to_end"]}
    for cell in cells:
        assert "setup_s" in e2e and cell in reported(e2e["setup_s"])
        assert any(cell in reported(m) for n, m in e2e.items()
                   if n != "setup_s")
        assert any(cell in reported(m) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in reported(m):
            assert cell in cells
            assert cell in reported(e2e[m["moves"]])


def test_files_found_by_name():
    b = bench()
    for c in b["configs"]:
        cfg = read_json(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(
            HERE, "generators", cfg["corpus_generator"] + ".py"))
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in b["workloads"]:
        traffic = read_json(os.path.join(HERE, "traffic",
                                         w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           traffic["driver"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert metric_reader(m["name"]).read


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]
            elif isinstance(arg, ast.Name):
                yield from _constant_of(tree, arg.id)


def _constant_of(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            yield node.value.value.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_no_jax_package():
    for path in _sources():
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)
        assert JAX_DIR not in open(path).read(), path


def test_yardstick_imports_nothing_of_the_program():
    for path in _sources():
        rel = os.path.relpath(path, HERE)
        if rel.startswith(YARDSTICK):
            assert "shredword_tpu_torch" not in set(_imports(path)), rel


def test_frozen_generator():
    from portbench.run import load_module
    data = load_module("generators", "heaps_words").make(16, 99,
                                                         pool_mb=1000)
    assert len(data) == 15_999_967 and data.endswith(b"\n")
    assert hashlib.sha256(data).hexdigest() == HEAPS16_SHA256
