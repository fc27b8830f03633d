"""The control of the comparison that decides ``correct``: the plain
reference with the configuration's tie rule broken (ties to the largest
pair), put in the program's place at a cell's own size and judged by the
same comparison.  It has to come out not correct on every seed.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

One JSON line a seed: the seed, ``correct`` and each number compared
beside its limit.  The benchmark's own runs do not run it; it needs no
card, and reads the cell's corpus and settings as a run does."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import compare, reference
from .drivers.train_jobs import make_corpus, trainer_kwargs
from .run import ROOT, cell_parts, read_json


def control_checks(config: dict, seed: int) -> tuple[list, float]:
    """((name, value, limit) of the control against the reference on the
    corpus of ``seed``, seconds taken)."""
    data = make_corpus(config, seed)
    kw = trainer_kwargs(config)
    t0 = time.perf_counter()
    ref = reference.train(data, **kw)
    ctl = reference.train(data, **kw, ties_to_largest=True)
    diffs = compare.job_diffs(ref, ctl.merges, ctl.merge_freqs, ctl.model,
                              ctl.vocab)
    return compare.combine([diffs]), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, _ = cell_parts(bench, args.workload)
    for seed in args.seeds:
        checks, secs = control_checks(config, seed)
        correct = all(v <= lim for _, v, lim in checks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "seconds": secs,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
