#!/usr/bin/env python3
"""F1 (the flat engine's loop, csrc/flat.cu) of several checkouts of this
repository, one after another on one NVIDIA GPU, so that two versions
are compared within one run on one card.

    python3 flat_compare.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding a tree of this repository (for
example the parent commit unpacked with `git archive`).  Its own
shredword_tpu_torch package is built and imported in a fresh process,
with the helpers of this checkout's chip_smoke.py, and measured on:
  - the 16 MB long-word corpus at vocab 32768: the first 128 merges and
    the whole run in calls of 64 (CUDA events around each call, its
    readback included), twice, after a warm-up call on a seeded stream;
  - the slice, BPETrainer(vocab 32768) train() on that corpus, twice,
    then once over a one-rank NCCL group (BPETrainer(mesh=...): the
    sharded flat route, S1 from PR 20 on, before it the per-merge
    recount) (seconds, peak device memory, the .model digest);
  - engine="flat" on the bench corpus at vocab 768, 4096, 32768 and
    65536 (train() seconds, the .model digest).
Lines start with "[compare] <checkout name>"; the card's name and power
limit end each checkout's block.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(root: str) -> None:
    """Everything above for the checkout at root, in this process."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    import shredword_tpu_torch
    from shredword_tpu_torch.bench import make_corpus
    from shredword_tpu_torch.ops import _kernels, bpe_ops
    from torch_flat_cases import FLAT_CASES, flat_corpus

    assert shredword_tpu_torch.__file__.startswith(root)
    tag = f"[compare] {os.path.basename(root)}"
    dev = torch.device("cuda", 0)
    _kernels.build()
    if not hasattr(bpe_ops.FlatState, "visited"):     # before the counter
        bpe_ops.FlatState.visited = 0
    ckw, target, _, unk, minf = FLAT_CASES["long_words"]
    err, *_ = c.flat_both(flat_corpus(**ckw), dev, target=target, unk=unk,
                          minf=minf, steps=64)
    print(f"{tag}: warm-up long_words, max |F1 - plain| = {err}")
    target = c.GIANT_VOCAB - 256
    with tempfile.TemporaryDirectory() as tmp:
        txt, arrays = c.long_corpus(dev, tmp)
        for _ in range(2):
            k, _ = c.flat_states(arrays, dev, target)
            first = whole = 0.0
            while not k.done and k.n_merges < target:
                out = {}
                ms = c.elapsed_ms(lambda: out.__setitem__(
                    "k", _kernels.flat_train(
                        k, c.GIANT["unk_id"], c.GIANT["min_pair_freq"],
                        target_merges=target, max_steps=64)), dev)
                if k.n_merges < c.TIMED_MERGES:
                    first += ms
                whole += ms
                k = out["k"]
            print(f"{tag}: first {c.TIMED_MERGES} merges "
                  f"{first / c.TIMED_MERGES:.6f}, whole run "
                  f"{whole / k.n_merges:.6f} ms per merge")
            del k, out
        for what in ("", "", "over NCCL world 1 "):
            with one_rank_nccl(c, dev, bool(what)) as kw:
                n, secs, _, peak, model, _ = c.train_and_save(
                    txt, tmp, c.GIANT_VOCAB, dev, "auto", c.GIANT,
                    tag="_long", **kw)
            print(f"{tag}: slice {what}train {secs:.4f} s, {n} merges, "
                  f"peak {peak / 1e9:.3f} GB, .model sha256 "
                  f"{hashlib.sha256(model).hexdigest()[:16]}", flush=True)
        corpus = os.path.join(tmp, "corpus.txt")
        make_corpus(corpus)
        for v in (768, 4096, c.GIANT_VOCAB, 65536):
            n, secs, _, _, model, _ = c.train_and_save(
                corpus, tmp, v, dev, "flat",
                c.HEADLINE if v <= 4096 else c.GIANT)
            print(f"{tag}: engine=flat vocab {v}: {secs:.4f} s, {n} "
                  f"merges, .model sha256 "
                  f"{hashlib.sha256(model).hexdigest()[:16]}")
    print(c.run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]), flush=True)


@contextlib.contextmanager
def one_rank_nccl(c, dev, on: bool):
    """BPETrainer's mesh argument inside the block: a one-rank NCCL
    group's when ``on`` (destroyed on leaving), else none."""
    if not on:
        yield {}
        return
    import torch.distributed as dist

    from shredword_tpu_torch.parallel import multihost

    multihost.initialize(f"tcp://localhost:{c.free_port()}", world_size=1,
                         rank=0)
    try:
        c.first_collective(dev)
        yield dict(mesh=multihost.global_mesh())
    finally:
        dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("flat_compare: no CUDA device available", file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
