"""A benchmark description whose configurations are cut to a size that a
CPU test run holds: the cells of ``BENCHMARK.json`` with each
configuration's vocab and corpus made small, in files of their own."""

from __future__ import annotations

import copy
import json
import os

from portbench.run import ROOT, read_json

TINY = {"target_vocab_size": 400, "corpus_mb": 0.03}


def bench() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_bench(tmp_path) -> dict:
    out = copy.deepcopy(bench())
    for conf in out["configs"]:
        cfg = read_json(os.path.join(ROOT, conf["file"]))
        cfg.update(TINY)
        path = tmp_path / f"{conf['name']}.json"
        path.write_text(json.dumps(cfg))
        conf["file"] = str(path)
    return out
