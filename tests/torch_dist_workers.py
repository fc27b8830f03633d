"""Rank workers for tests/test_torch_parallel.py,
tests/test_torch_sharded_giant.py and tests/test_torch_sharded_flat.py,
and a one-rank gloo group in the test's own process.

Each rank runs in its own spawned process with one thread, joins a gloo
process group through a FileStore under the test's tmp directory (so
parallel test workers never race for a port), runs a function of this
module and pickles what it returns.  This module imports no JAX.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def one_rank_gloo(store: str):
    """A one-rank gloo process group in this process (a FileStore at
    `store`), destroyed on leaving the block."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(store, 1))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


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
    checkpoint resumed sharded, a shards=N that does not match the world
    size, and the ranks' split of a work list."""
    from shredword_tpu_torch.errors import ConfigError
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
    try:
        _trainer(corpus, shards=3).train()
        out["world"] = None
    except ConfigError as e:
        out["world"] = str(e)
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


def _logged(fn):
    """(fn(), the messages the port logged at info level meanwhile)."""
    import logging

    logged = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger("shredword_tpu_torch")
    logger.addHandler(handler)
    try:
        return fn(), logged
    finally:
        logger.removeHandler(handler)


def _engine_of(logged) -> str:
    """The sharded engine named by a trainer's completion message."""
    for msg in logged:
        if "sharded" in msg and "engine" in msg:
            return msg.split("sharded ")[1].split(" engine")[0]
    return ""


# the int16-crossing envelope of tests/test_giant_64k_envelope.py
ENVELOPE_N_PREV = 32510
ENVELOPE_TARGET = ENVELOPE_N_PREV + 14


def envelope_corpus():
    """Two 8-token chain words near the int16 limit (counts 100 and 50):
    (tokens, word_id, per-word counts, per-position counts)."""
    tokens = np.concatenate([np.arange(31000, 31008, dtype=np.int32),
                             np.arange(31100, 31108, dtype=np.int32)])
    word_id = np.repeat(np.arange(2, dtype=np.int32), 8)
    counts = np.asarray([100, 50], np.int32)
    return tokens, word_id, counts, counts[word_id]


# a resume near v: chain words of ids near 256 + n_prev, so the replayed
# ids' [vi, vi] table (vi = 2176) would be larger than a rank's rows
NEAR_V_N_PREV = 1900
NEAR_V_TARGET = NEAR_V_N_PREV + 14


def near_v_corpus():
    tokens = np.concatenate([np.arange(2000, 2008, dtype=np.int32),
                             np.arange(2050, 2058, dtype=np.int32)])
    word_id = np.repeat(np.arange(2, dtype=np.int32), 8)
    counts = np.asarray([100, 50], np.int32)
    return tokens, word_id, counts, counts[word_id]


def _largest_tensors(fn):
    """(fn(), the shape of the largest tensor any PyTorch op made while
    it ran)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    largest = [()]

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(t, torch.Tensor) and \
                        t.numel() > int(np.prod(largest[0])):
                    largest[0] = tuple(t.shape)
            return out

    with Record():
        result = fn()
    return result, largest[0]


def sharded_giant_engine(arrays) -> tuple:
    """sharded_giant_train on `arrays` as tests/test_parallel.py:155
    drives the JAX engine."""
    from shredword_tpu_torch.parallel import giant

    return giant.sharded_giant_train(
        *arrays, mesh=dist.group.WORLD, target_merges=32, min_pair_freq=2,
        max_steps_per_call=16, device="cpu")


def sharded_giant_scenarios(corpus: str, arrays, tmp_dir: str) -> dict:
    """Everything test_torch_sharded_giant.py checks in two ranks, in one
    start-up: the engine on `arrays`; BPETrainer(shards=2) above vocab
    4096 on `corpus` (and which engine it logged), a sharded resume of it
    and a single-device checkpoint resumed sharded; the int16-crossing
    envelope on the giant and flat engines; a resume near v with the
    largest tensor any op made."""
    from shredword_tpu_torch.parallel import giant, train

    out = {"engine": sharded_giant_engine(arrays)}
    big = dict(target_vocab_size=4500)
    out["full"], out["full_log"] = _logged(
        lambda: _trained(corpus, tmp_dir, "full", shards=2, **big))
    cp = os.path.join(tmp_dir, f"g_half.r{dist.get_rank()}.ckpt")
    half = _trainer(corpus, shards=2, **big)
    out["half"] = half.train(max_merges=12)
    half.save_checkpoint(cp)
    out["resumed"] = _trained(corpus, tmp_dir, "g_resumed", shards=2,
                              prev=cp, **big)
    single = os.path.join(tmp_dir, f"g_single.r{dist.get_rank()}.ckpt")
    one = _trainer(corpus, **big)                  # no process group used
    one.train(max_merges=10)
    one.save_checkpoint(single)
    out["single_resumed"] = _trained(corpus, tmp_dir, "g_single_resumed",
                                     shards=2, prev=single, **big)
    for key, make, n_prev, target in (
            ("envelope", envelope_corpus, ENVELOPE_N_PREV, ENVELOPE_TARGET),
            ("near_v", near_v_corpus, NEAR_V_N_PREV, NEAR_V_TARGET)):
        tokens, word_id, counts, wcount = make()
        kw = dict(mesh=dist.group.WORLD, target_merges=target, unk_id=-1,
                  min_pair_freq=2, n_prev_merges=n_prev, device="cpu")
        out[key] = _largest_tensors(lambda: giant.sharded_giant_train(
            tokens, word_id, counts, **kw))
        out[key + "_flat"] = train.sharded_train(tokens, word_id, wcount,
                                                 **kw)
    return out


def sharded_flat_scenarios(corpus: str, tmp_dir: str) -> dict:
    """Everything test_torch_sharded_flat.py checks in two ranks, in one
    start-up: sharded_train on the corpus's flat arrays and its resume
    after 12 merges; BPETrainer(shards=2) with the table engines patched
    to decline (tests/test_parallel.py:132) and on a corpus whose words
    pass 64 tokens, with the engine each logged."""
    from shredword_tpu_torch.parallel import giant, hist, train

    t = _trainer(corpus)
    tokens, word_id, wcount = t._token_arrays()
    kw = dict(mesh=dist.group.WORLD, unk_id=-1, min_pair_freq=5,
              target_merges=60, device="cpu")
    out = {"engine": train.sharded_train(tokens, word_id, wcount, **kw)}
    replayed = arrays_after((tokens, word_id, wcount),
                            out["engine"][0][:12])
    counts = t._word_counts()
    out["engine_resumed"] = train.sharded_train(
        replayed[0], replayed[1], counts[replayed[1]], n_prev_merges=12,
        **kw)
    engines = (hist.sharded_hist_train, giant.sharded_giant_train)
    hist.sharded_hist_train = giant.sharded_giant_train = \
        lambda *a, **k: None
    try:
        out["fallback"], out["fallback_log"] = _logged(lambda: _trained(
            corpus, tmp_dir, "fallback", shards=2, target_vocab_size=2400))
    finally:
        hist.sharded_hist_train, giant.sharded_giant_train = engines
    long_corpus = os.path.join(tmp_dir, f"long.r{dist.get_rank()}.txt")
    with open(long_corpus, "wb") as f:
        f.write((b"x" * 100 + b" the quick brown fox\n") * 20)
    out["long"], out["long_log"] = _logged(lambda: _trained(
        long_corpus, tmp_dir, "long", shards=2, target_vocab_size=300,
        character_coverage=0.9999, min_pair_freq=2))
    return out


SHARDED_STEPS = (1, 7, 256)     # max_steps_per_call of sharded_flat_calls
GLUE_MERGES = 6                 # plain merges of exchange_tables
FIXED_MERGES = 16               # merges of fixed_exchange_tables
FIXED_ROWS = (4096, 4)          # its rows a list: S1's first, a fallback's


def sharded_flat_calls() -> dict:
    """sharded_train (its plain version, on the CPU) on every case of
    torch_flat_cases.SHARDED_CASES in calls of each of SHARDED_STEPS
    merges: {(case, steps): (merges, freqs)}; under "glue" the delta
    exchange's host glue on the first case (exchange_tables)."""
    from torch_flat_cases import SHARDED_CASES, flat_corpus

    from shredword_tpu_torch.parallel import train

    out = {}
    for case, (ckw, target, n_prev, unk, minf) in SHARDED_CASES.items():
        arrays = flat_corpus(**ckw)
        for steps in SHARDED_STEPS:
            out[case, steps] = train.sharded_train(
                *arrays, mesh=dist.group.WORLD, target_merges=target,
                unk_id=unk, min_pair_freq=minf, max_steps_per_call=steps,
                n_prev_merges=n_prev, device="cpu")
    ckw, _, _, unk, _ = SHARDED_CASES["long_words_unk"]
    out["glue"] = exchange_tables(flat_corpus(**ckw), unk, GLUE_MERGES)
    for rows in FIXED_ROWS:
        out["fixed", rows] = fixed_exchange_tables(flat_corpus(**ckw), unk,
                                                   FIXED_MERGES, rows)
    return out


def _table(rows) -> tuple[np.ndarray, np.ndarray]:
    """(keys, counts) of a table's int64 (key, count) rows, zeros
    dropped."""
    live = rows[:, 1] != 0
    return rows[live, 0].numpy(), rows[live, 1].numpy()


def exchange_tables(arrays, unk: int, merges: int) -> list:
    """The host glue of S1's delta exchange on this rank's span, with the
    table added up on the host: the whole corpus's pair counts from
    train.initial_deltas, then after each of `merges` plain merges
    (picked by train.global_best_pair, min_pair_freq 1) with every
    rank's net deltas (its span's pair counts after the merge less those
    before) gathered by train.gather_padded and added.  Returns [(the
    whole stream's length, table), ((a, b), table), ...]."""
    from shredword_tpu_torch.ops import bpe_ops
    from shredword_tpu_torch.parallel import train

    group = dist.group.WORLD
    sc = train.shard_corpus(*arrays, group.size())
    st = train.local_state(sc, group.rank(), "cpu")
    n_all, table = train.initial_deltas(st, unk, group)
    out = [(n_all, _table(table))]
    for i in range(merges):
        a, b, _ = train.global_best_pair(st, unk, 1, group)
        kb, cb = bpe_ops.pair_counts(st, unk)
        st = bpe_ops.apply_merge(st, a, b, 256 + i)
        ka, ca = bpe_ops.pair_counts(st, unk)
        keys, delta = bpe_ops.sum_by_key(torch.cat([kb, ka]),
                                         torch.cat([-cb, ca]))
        rows = torch.stack([keys, delta], 1)[delta != 0]
        got = train.gather_padded(rows, len(rows), group)
        got = got[got[:, 0] >= 0]
        keys, counts = bpe_ops.sum_by_key(torch.cat([table[:, 0], got[:, 0]]),
                                          torch.cat([table[:, 1], got[:, 1]]))
        table = torch.stack([keys, counts], 1)
        out.append(((a, b), _table(table)))
    return out


def fixed_exchange_tables(arrays, unk: int, merges: int, rows: int,
                          flag=None) -> dict:
    """The host glue of S1's fixed-size exchange on this rank's span, in
    its plain version, with the table added up on the host: the whole
    corpus's pair counts from train.initial_deltas, then `merges` merges,
    each picked from that table (bpe_ops.best_of, min_pair_freq 1) and
    applied by the plain version, after which every rank's compact list
    (train.pack_rows of its span's net deltas, summed by key, zeros and
    (a, b) left out) goes through train.exchange_deltas at `rows` rows a
    list, and the gathered rows are added to the table with (a, b)'s
    count set to 0.  flag=(rank, merge): that rank flags an overflow in
    that merge's header.  Returns the whole stream's length, the table
    after the start and after each merge, the merges, the rows after
    each exchange and, when the exchange raised, (the merge, the
    message)."""
    from shredword_tpu_torch.ops import bpe_ops
    from shredword_tpu_torch.parallel import train

    group = dist.group.WORLD
    sc = train.shard_corpus(*arrays, group.size())
    st = train.local_state(sc, group.rank(), "cpu")
    n_all, table = train.initial_deltas(st, unk, group)
    out = dict(n_all=n_all, tables=[_table(table)], merges=[], rows=[],
               raised=None)
    for i in range(merges):
        a, b, c = bpe_ops.best_of(table[:, 0], table[:, 1], 1)
        assert c > 0
        ab = a << 32 | b
        kb, cb = bpe_ops.pair_counts(st, unk)
        st = bpe_ops.apply_merge(st, a, b, 256 + i)
        ka, ca = bpe_ops.pair_counts(st, unk)
        keys, delta = bpe_ops.sum_by_key(torch.cat([kb, ka]),
                                         torch.cat([-cb, ca]))
        keep = (delta != 0) & (keys != ab)
        send = train.pack_rows(torch.stack([keys, delta], 1)[keep],
                               int(flag == (group.rank(), i)))
        try:
            got, rows = train.exchange_deltas(send, rows, group)
        except RuntimeError as e:
            out["raised"] = (i, str(e))
            break
        table[table[:, 0] == ab, 1] = 0
        keys, counts = bpe_ops.sum_by_key(torch.cat([table[:, 0], got[:, 0]]),
                                          torch.cat([table[:, 1], got[:, 1]]))
        table = torch.stack([keys, counts], 1)
        out["tables"].append(_table(table))
        out["merges"].append((a, b))
        out["rows"].append(rows)
    return out


OVERFLOW_MERGE = 2      # the merge whose header overflow_raises flags


def overflow_raises() -> dict:
    """fixed_exchange_tables with the last rank flagging an overflow in
    merge OVERFLOW_MERGE's header."""
    from torch_flat_cases import SHARDED_CASES, flat_corpus

    ckw, _, _, unk, _ = SHARDED_CASES["long_words_unk"]
    return fixed_exchange_tables(
        flat_corpus(**ckw), unk, FIXED_MERGES, FIXED_ROWS[0],
        flag=(dist.get_world_size() - 1, OVERFLOW_MERGE))


def chain_launches(n: int, done: bool, steps: int, target: int,
                   fallbacks) -> int:
    """The launches one call of S1's chain above world 1 makes, from
    merge n (done: none), in calls of `steps`: two for each merge it
    plans, and two for each merge it runs again after each fallback
    (the merges at which the call's fallbacks halted the chain)."""
    planned = 0 if done else min(steps, target - n)
    return 2 * planned + sum(2 * (n + planned - g) for g in fallbacks)


def chain_call(fn, ts, unk, minf, **kw):
    """(fn(ts, ...), the launches chain_launches expects of that call of
    S1's chain): fn is _kernels.flat_sharded_train."""
    from shredword_tpu_torch.ops import bpe_ops

    fs = ts.corpus
    seen = len(fs.fallbacks) if isinstance(fs, bpe_ops.FlatState) else 0
    n, done = ts.n_merges, ts.done
    ts = fn(ts, unk, minf, **kw)
    return ts, chain_launches(
        n, done, kw["max_steps"], kw["target_merges"],
        ts.corpus.fallbacks[seen:])


class ChainCounter:
    """Stands in for _kernels.flat_sharded_train (the wrapper then counts
    its launches here) while a run above world 1 calls it: the launches
    chain_launches expects of every call, summed in `expected`."""

    def __init__(self, fn):
        self.fn, self.launches, self.expected = fn, 0, 0

    def __call__(self, ts, unk, minf, **kw):
        ts, want = chain_call(self.fn, ts, unk, minf, **kw)
        self.expected += want
        return ts


def s1_calls(dev: str, steps: int, cases=None, rows=None) -> dict:
    """S1 (_kernels.flat_sharded_train on `dev`, a card) against its
    plain version (the same wrapper on CPU tensors), call by call in
    calls of `steps` merges with `rows` rows a list in the exchange
    (S1's default when None), on this rank's span of every stream of
    torch_flat_cases.FLAT_CASES (or of those named in `cases`), then one
    call past the end; per case whether every call's records, merge
    count, done and the span's compacted stream were identical, the
    kernel's new merges, its launches, the launches chain_launches
    expects of its calls, its calls, the merges at which it fell back and
    the rows of its last exchange, and the calls of bpe_ops.pair_counts
    the kernel's runs made; under "sharded_train" the same for
    parallel.train.sharded_train on the card on the long_words stream
    (its merges == the calls' there)."""
    from torch_flat_cases import FLAT_CASES, flat_corpus

    from shredword_tpu_torch.ops import _kernels, bpe_ops
    from shredword_tpu_torch.parallel import train

    torch.cuda.set_device(torch.device(dev).index or 0)
    group = dist.group.WORLD
    counted = []
    pair_counts = bpe_ops.pair_counts

    def spied(*args):
        counted.append(1)
        return pair_counts(*args)

    bpe_ops.pair_counts = spied
    out = {}
    try:
        for case in sorted(FLAT_CASES if cases is None else cases):
            ckw, target, n_prev, unk, minf = FLAT_CASES[case]
            sc = train.shard_corpus(*flat_corpus(**ckw), group.size())
            want, got = (bpe_ops.train_init(
                train.local_state(sc, group.rank(), d), target, n_prev)
                for d in ("cpu", dev))
            kw = dict(target_merges=target, max_steps=steps, group=group)
            n0, calls, spied_n, same = (_kernels.flat_sharded_train.launches,
                                        0, 0, True)
            expected = 0
            while not want.done and want.n_merges < target:
                want = _kernels.flat_sharded_train(want, unk, minf, **kw)
                c0 = len(counted)
                got, e = chain_call(_kernels.flat_sharded_train, got, unk,
                                    minf, rows=rows, **kw)
                expected += e
                spied_n += len(counted) - c0
                calls += 1
                same &= ((got.n_merges, got.done) == (want.n_merges,
                                                      want.done)
                         and np.array_equal(got.merges, want.merges)
                         and np.array_equal(got.merge_freqs,
                                            want.merge_freqs)
                         and all(torch.equal(x.cpu(), y) for x, y in zip(
                             bpe_ops.final_corpus(got.corpus),
                             want.corpus)))
            launches = _kernels.flat_sharded_train.launches - n0
            again = _kernels.flat_sharded_train(got, unk, minf, **kw)
            same &= (again.n_merges, again.done) == (got.n_merges, got.done)
            out[case] = dict(
                same=same, merges=got.merges[n_prev:got.n_merges].copy(),
                done=got.done, launches=launches, expected=expected,
                calls=calls, fallbacks=list(got.corpus.fallbacks),
                rows=got.corpus.rows,
                past_end=_kernels.flat_sharded_train.launches - n0
                - launches, pair_counts=spied_n)
        ckw, target, _, unk, minf = FLAT_CASES["long_words"]
        c0 = len(counted)
        counter = ChainCounter(_kernels.flat_sharded_train)
        _kernels.flat_sharded_train = counter
        try:
            merges, _ = train.sharded_train(
                *flat_corpus(**ckw), mesh=group, target_merges=target,
                unk_id=unk, min_pair_freq=minf, device=dev)
        finally:
            _kernels.flat_sharded_train = counter.fn
        out["sharded_train"] = dict(
            same=np.array_equal(merges, out["long_words"]["merges"]),
            merges=merges, done=len(merges) < target,
            launches=counter.launches, expected=counter.expected, calls=1,
            past_end=0, pair_counts=len(counted) - c0)
    finally:
        bpe_ops.pair_counts = pair_counts
    return out


def s1_lists(dev: str, cases=None) -> dict:
    """S1's compact lists on `dev` (a card) merge by merge, in calls of
    one merge, on this rank's span of every stream of
    torch_flat_cases.FLAT_CASES (or of those named in `cases`), against
    bpe_ops.sum_by_key of the span's pair counts before and after the
    merge in the plain version (zeros and (a, b) left out, as every rank
    sets (a, b)'s count itself); per case the merges compared, those
    whose list differed (header count, flags or rows), the rows listed
    and those the exact rule gives over the run, and whether the records
    equalled the plain version's."""
    from torch_flat_cases import FLAT_CASES, flat_corpus

    from shredword_tpu_torch.ops import _kernels, bpe_ops
    from shredword_tpu_torch.parallel import train

    torch.cuda.set_device(torch.device(dev).index or 0)
    group = dist.group.WORLD
    out = {}
    for case in sorted(FLAT_CASES if cases is None else cases):
        ckw, target, n_prev, unk, minf = FLAT_CASES[case]
        sc = train.shard_corpus(*flat_corpus(**ckw), group.size())
        want, got = (bpe_ops.train_init(
            train.local_state(sc, group.rank(), d), target, n_prev)
            for d in ("cpu", dev))
        kw = dict(target_merges=target, max_steps=1, group=group)
        merges, wrong, exact, same = 0, [], 0, True
        while not want.done and want.n_merges < target:
            kb, cb = bpe_ops.pair_counts(want.corpus, unk)
            want = _kernels.flat_sharded_train(want, unk, minf, **kw)
            got = _kernels.flat_sharded_train(got, unk, minf, **kw)
            same &= ((got.n_merges, got.done) == (want.n_merges, want.done)
                     and np.array_equal(got.merges, want.merges))
            if want.done:
                break
            a, b = (int(x) for x in want.merges[want.n_merges - 1])
            ka, ca = bpe_ops.pair_counts(want.corpus, unk)
            keys, delta = bpe_ops.sum_by_key(torch.cat([kb, ka]),
                                             torch.cat([-cb, ca]))
            keep = (delta != 0) & (keys != (a << 32 | b))
            rows = torch.stack([keys, delta], 1)[keep]
            send = got.corpus.send.cpu()
            n = int(send[0, 0])
            lst = send[1:1 + n]
            lst = lst[torch.argsort(lst[:, 0])]
            if int(send[0, 1]) != 0 or not torch.equal(lst, rows):
                wrong.append(want.n_merges - 1)
            merges += 1
            exact += len(rows)
        out[case] = dict(merges=merges, wrong=wrong, same=same,
                         listed=got.corpus.listed, exact=exact)
    return out


def s1_builds(dev: str, repeats: int) -> dict:
    """The start of S1's chain on `dev` (a card), as every rank makes it
    in its first call, `repeats` times on this rank's span of every
    stream of torch_flat_cases.FLAT_CASES, each step synchronised so
    that a device-side fault names it: the span's arrays read back and
    checked (the token range, the word ids, the lengths),
    train.initial_deltas over the group, then bpe_ops.FlatState of the
    span with the whole stream's length, its layout, presence index and
    signatures against a FlatState built on the CPU.  Returns per case
    the builds made and those that differed (by name)."""
    from torch_flat_cases import FLAT_CASES, flat_corpus

    from shredword_tpu_torch.ops import bpe_ops
    from shredword_tpu_torch.parallel import train

    device = torch.device(dev)
    torch.cuda.set_device(device.index or 0)
    group = dist.group.WORLD
    out = {}
    for case in sorted(FLAT_CASES):
        ckw, _, _, unk, _ = FLAT_CASES[case]
        arrays = flat_corpus(**ckw)
        sc = train.shard_corpus(*arrays, group.size())
        cpu = train.local_state(sc, group.rank(), "cpu")
        want = bpe_ops.FlatState(cpu, table_n=len(arrays[0]))
        wrong = []
        for _ in range(repeats):
            state = train.local_state(sc, group.rank(), device)
            torch.cuda.synchronize(device)
            t, wid, wc = (x.cpu() for x in state)
            m = int(sc.lengths[group.rank()])
            if not (len(t) == len(wid) == len(wc) == m
                    and bool(((t >= 0) | (t == unk)).all())
                    and bool((wid >= 0).all() and (wc >= 1).all())
                    and bool((wid[1:] >= wid[:-1]).all())):
                wrong.append("arrays")
            n_all, first = train.initial_deltas(state, unk, group)
            torch.cuda.synchronize(device)
            if n_all != len(arrays[0]) or bool((first[:, 1] < 1).any()):
                wrong.append("initial_deltas")
            fs = bpe_ops.FlatState(state, table_n=n_all)
            torch.cuda.synchronize(device)
            for name in ("off", "len", "wcnt", "pres", "sig"):
                if not torch.equal(getattr(fs, name).cpu(),
                                   getattr(want, name)):
                    wrong.append(name)
            if fs.cap != want.cap:
                wrong.append("cap")
            del fs, state, first
        out[case] = dict(builds=repeats, wrong=wrong)
    return out
