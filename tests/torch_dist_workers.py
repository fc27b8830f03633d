"""Rank workers for tests/test_torch_parallel.py.

Each rank runs in its own spawned process with one thread, joins a gloo
process group through a FileStore under the test's tmp directory (so
parallel test workers never race for a port), runs a function of this
module and pickles what it returns.  This module imports no JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(fn, world: int, tmp_dir: str, *args, timeout: float = 120):
    """fn(*args) in `world` gloo ranks; returns the ranks' results."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp_dir, "store")
    outs = [os.path.join(tmp_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive:
        raise TimeoutError(f"{len(alive)} rank(s) still running after "
                           f"{timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes} (tracebacks above)")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(fn, rank, world, store_path, out_path, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _trainer(corpus, **kw):
    from shredword_tpu_torch import BPETrainer

    cfg = dict(target_vocab_size=330, unk_id=-1, character_coverage=0.9995,
               min_pair_freq=5, device="cpu")
    t = BPETrainer(**{**cfg, **kw})
    t.load_corpus(corpus)
    return t


def _trained(corpus, tmp_dir, tag, *, max_merges=None, prev=None, **kw):
    """(merges, freqs, token frequencies, .model bytes, .vocab bytes)."""
    t = _trainer(corpus, **kw)
    if prev is not None:
        assert t.load_checkpoint(prev) > 0
    t.train(max_merges)
    mp = os.path.join(tmp_dir, f"{tag}.r{dist.get_rank()}.model")
    vp = os.path.join(tmp_dir, f"{tag}.r{dist.get_rank()}.vocab")
    t.save(mp, vp)
    with open(mp, "rb") as f, open(vp, "rb") as g:
        return (t.merges, t.merge_freqs, t.token_frequencies(), f.read(),
                g.read())


# name: (min_pair_freq, steps per call, target merges) of chain_calls
CHAIN_CASES = {
    "steps7": (2, 7, 30),
    "min_freq_stop": (700, 16, 40),      # stops after 24 merges
}


def chain_calls(arrays, min_freq: int, steps: int, target: int) -> list:
    """The sharded-call wrapper on this rank's column block, call by call
    as drive_calls makes them: each call's records, this rank's tokens
    and the table after it."""
    from shredword_tpu_torch.ops import _kernels, bpe_hist
    from shredword_tpu_torch.parallel import hist

    world, rank = dist.get_world_size(), dist.get_rank()
    c = hist.shard_layout(*arrays, world)
    v = -(-(256 + target) // 128) * 128
    ts = bpe_hist.hist_train_init(hist.local_shard(c, rank, world), -1,
                                  target, v, device="cpu")
    dist.all_reduce(ts.hist)
    (tw, wc), table = ts.corpus, ts.hist
    out, n, done = [], 0, 0
    while n < target and not done:
        allowed = target - n
        recs = _kernels.hist_sharded_train(
            tw, wc, table, reduce=dist.all_reduce, unk=-1, min_freq=min_freq,
            n_done=n, init_done=0, allowed=allowed,
            steps=min(steps, allowed))
        out.append((recs.numpy(), tw.numpy().copy(), table.numpy().copy()))
        n_new = int(recs[:, 3].sum())
        n, done = n + n_new, int(n_new < len(recs))
    return out


def scenarios(corpus: str, arrays, tmp_dir: str) -> dict:
    """Everything test_torch_parallel.py checks, in one start-up of the
    ranks: the sharded-call wrapper call by call (chain_calls) and the
    sharded engine on `arrays`, BPETrainer(shards=2) and
    BPETrainer(mesh=...) on `corpus`, a sharded resume, a single-device
    checkpoint resumed sharded, the routes that raise, and the ranks'
    split of a work list."""
    from shredword_tpu_torch.errors import ConfigError, TrainingError
    from shredword_tpu_torch.parallel import hist, multihost

    out = {"host_shard": multihost.host_shard(5)}
    out["chain"] = {name: chain_calls(arrays, *case)
                    for name, case in CHAIN_CASES.items()}
    tokens, word_id, wc_word = arrays
    out["engine"] = hist.sharded_hist_train(
        tokens, word_id, wc_word, mesh=dist.group.WORLD, target_merges=40,
        unk_id=-1, min_pair_freq=2, max_steps_per_call=16, device="cpu")
    out["engine_resumed"] = hist.sharded_hist_train(
        *arrays_after(arrays, out["engine"][0][:9]), mesh=dist.group.WORLD,
        target_merges=40, unk_id=-1, min_pair_freq=2, n_prev_merges=9,
        device="cpu")
    out["shards"] = _trained(corpus, tmp_dir, "shards", shards=2)
    out["mesh"] = _trained(corpus, tmp_dir, "mesh",
                           mesh=multihost.global_mesh("cpu"))
    cp = os.path.join(tmp_dir, f"half.r{dist.get_rank()}.ckpt")
    half = _trainer(corpus, shards=2)
    out["half"] = half.train(max_merges=12)
    half.save_checkpoint(cp)
    out["resumed"] = _trained(corpus, tmp_dir, "resumed", shards=2, prev=cp)
    single = os.path.join(tmp_dir, f"single.r{dist.get_rank()}.ckpt")
    one = _trainer(corpus)                         # no process group used
    one.train(max_merges=10)
    one.save_checkpoint(single)
    out["single_resumed"] = _trained(corpus, tmp_dir, "single_resumed",
                                     shards=2, prev=single)
    for key, kw, err in (("giant", dict(target_vocab_size=5000, shards=2),
                          TrainingError),
                         ("world", dict(shards=3), ConfigError)):
        t = _trainer(corpus, **kw)
        try:
            t.train()
            out[key] = None
        except err as e:
            out[key] = str(e)
    return out


def arrays_after(arrays, merges):
    """The flat arrays with `merges` replayed (checkpoint resume), by the
    port's native encoder."""
    from shredword_tpu_torch.runtime import native

    tokens, word_id, wc_word = arrays
    lengths = np.bincount(word_id)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    enc = native.NativeEncoder(merges)
    tokens, off = enc.apply_merges(tokens, offsets)
    enc.free()
    word_id = np.repeat(np.arange(len(lengths), dtype=np.int32),
                        np.diff(off))
    return tokens, word_id, wc_word


def unigram_sharded(corpus: str, kw: dict) -> list:
    """UnigramTrainer(shards=world) and UnigramTrainer(mesh=...) on this
    rank's word blocks: (pieces, log_probs, final_ll) of each."""
    from shredword_tpu_torch import UnigramTrainer
    from shredword_tpu_torch.parallel import multihost

    out = []
    for shard_kw in (dict(shards=dist.get_world_size()),
                     dict(mesh=multihost.global_mesh("cpu"))):
        t = UnigramTrainer(**kw, device="cpu", **shard_kw)
        t.load_corpus(corpus)
        t.train()
        out.append((t.pieces, t.log_probs, t.final_ll))
    return out
