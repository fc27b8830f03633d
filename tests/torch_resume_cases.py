"""Checkpoint and resume runs of the port's BPETrainer, shared by the CPU
tests (tests/test_torch_resume.py, against the JAX package) and the card
tests (tests/test_torch_cuda.py -k resume).  Imports no JAX."""

import contextlib
import os
import shutil

import numpy as np

from shredword_tpu_torch import BPETrainer
from shredword_tpu_torch import checkpoint as port_ckpt

# target vocab, unk_id, coverage, min_pair_freq: 344 merges on the zipf
# corpus, none of them stopped by min_pair_freq
CFG = (600, -1, 0.995, 10)
MERGES = CFG[0] - 256
# checkpoint_every: it divides neither the run's 344 merges nor the flat
# engine's calls of merges_per_device_call (64)
EVERY = 100
# the merges each engine's mid-run checkpoints hold: the table engines
# run calls of EVERY merges and write after each (the last one short);
# the flat engine writes after a call of 64 that crosses a multiple of
# EVERY, so its last file holds 320
WRITTEN = {"hist": (100, 200, 300, 344), "giant": (100, 200, 300, 344),
           "flat": (128, 256, 320)}
# the sharded routes: (config, corpus) that takes each engine.  Above
# vocab 4096 the sharded route takes the row-sharded giant engine; a word
# over 64 tokens (the long-word corpus) the sharded flat engine
SHARDED = {"hist": (CFG, "zipf"), "giant": ((4608, -1, 0.995, 10), "zipf"),
           "flat": ((640, 0, 0.995, 2), "long")}
# the single-device kernel wrapper each engine launches on the card
KERNEL = {"hist": "hist_fused_train", "giant": "giant_train_step",
          "flat": "flat_train"}
SHARDED_KERNEL = {"hist": "hist_sharded_train",
                  "giant": "giant_sharded_train",
                  "flat": "flat_sharded_train"}


def trainer(cfg, path, engine="auto", device="cpu", **kw) -> BPETrainer:
    t = BPETrainer(*cfg, engine=engine, device=device, **kw)
    t.load_corpus(path)
    return t


def outputs(t: BPETrainer, out_dir, tag: str) -> tuple:
    """(merges, merge_freqs, .model bytes, .vocab bytes, token
    frequencies) of a trained trainer."""
    mp = os.path.join(out_dir, f"{tag}.model")
    vp = os.path.join(out_dir, f"{tag}.vocab")
    t.save(mp, vp)
    with open(mp, "rb") as f, open(vp, "rb") as g:
        model, vocab = f.read(), g.read()
    return (t.merges.tolist(), t.merge_freqs.tolist(), model, vocab,
            t.token_frequencies().tolist())


@contextlib.contextmanager
def captured(out_dir):
    """Every checkpoint that the port writes inside the block, copied as
    it is written: yields a list that fills with (merges it holds, path
    of the copy)."""
    files: list = []
    save = port_ckpt.save_checkpoint

    def capture(path, **kw):
        save(path, **kw)
        copy = os.path.join(out_dir, f"captured_{len(files)}.ckpt")
        shutil.copyfile(path, copy)
        files.append((len(kw["merges"]), copy))

    port_ckpt.save_checkpoint = capture
    try:
        yield files
    finally:
        port_ckpt.save_checkpoint = save


def checkpointed(cfg, path, out_dir, engine="auto", device="cpu",
                 every=EVERY, max_merges=None, **kw):
    """A run with checkpoint_path and checkpoint_every=every: (the
    trainer, what train() returned, [(merges, path)] of every checkpoint
    it wrote, in order)."""
    ck = os.path.join(out_dir, "running.ckpt")
    with captured(out_dir) as files:
        t = trainer(cfg, path, engine, device, checkpoint_path=ck,
                    checkpoint_every=every, **kw)
        n = t.train(max_merges)
    return t, n, list(files)


def is_prefix(ckpt_path: str, merges, freqs) -> bool:
    """Whether the checkpoint holds the first merges and frequencies of
    a run."""
    _, m, f = port_ckpt.load_checkpoint(ckpt_path)
    return (len(m) <= len(merges)
            and np.array_equal(m, np.asarray(merges[:len(m)],
                                             np.int32).reshape(-1, 2))
            and np.array_equal(f, np.asarray(freqs[:len(m)], np.int64)))


def resumed(cfg, path, ckpt_path, engine="auto", device="cpu", **kw):
    """A fresh trainer resumed from ckpt_path: (the trainer, merges the
    checkpoint held, merges train() added)."""
    t = trainer(cfg, path, engine, device, **kw)
    n0 = t.load_checkpoint(ckpt_path)
    return t, n0, t.train()
