"""The port's CUDA kernels against their plain PyTorch versions.

These tests import no JAX, so they also run where only PyTorch is
installed.  The ``cuda`` ones need a card and skip without one; run them
there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from golden.corpus_gen import zipf_corpus
from torch_encode_cases import (FHUS, boundary_cases, high_id_merges,
                                random_chunks, random_merges)
from torch_flat_cases import FLAT_CASES, flat_corpus
from torch_pretok_cases import all_inputs, code_points
from torch_resume_cases import (CFG, KERNEL, MERGES, SHARDED, SHARDED_KERNEL,
                                WRITTEN, checkpointed, is_prefix, outputs,
                                resumed, trainer)
from torch_unigram_cases import (LATTICES, OVERFLOW_CONFIG, OVERFLOW_TEXT,
                                 overflow_lattice, random_lattice)

from shredword_tpu_torch import (BPETrainer, Tokenizer, UnigramTokenizer,
                                 UnigramTrainer)
from shredword_tpu_torch.bench import make_long_corpus
from shredword_tpu_torch.ops import (_kernels, bpe_giant, bpe_hist, bpe_ops,
                                     encode_ops, pretok_ops, unigram_ops)


def _corpus(seed, n_words=400, alpha=6, max_len=12, unk=None,
            equal_weights=False):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    lens[:10] = max_len                                 # 'aaaa...' runs
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < 10] = 97
    if unk is not None:
        tokens[rng.rand(len(tokens)) < 0.05] = unk
    wc_word = rng.randint(1, 60, n_words).astype(np.int32)
    if equal_weights:                                   # many tied counts
        wc_word[:] = 1
    return tokens, word_id, wc_word


# name: (corpus arguments, hist_train keyword arguments)
CASES = {
    "plain": (dict(seed=0), dict(target_merges=60)),
    "unk_byte": (dict(seed=1, unk=98), dict(target_merges=40, unk_id=98)),
    "chunked": (dict(seed=2), dict(target_merges=50, max_steps_per_call=7)),
    "min_freq_stop": (dict(seed=3), dict(target_merges=80,
                                         min_pair_freq=300,
                                         max_steps_per_call=16)),
    "rows32": (dict(seed=4, max_len=30, alpha=4), dict(target_merges=40)),
    "rows64": (dict(seed=5, max_len=60, alpha=3), dict(target_merges=40)),
    "n_prev": (dict(seed=6), dict(target_merges=50, n_prev_merges=13)),
    "vocab4096": (dict(seed=7, n_words=3000, alpha=12),
                  dict(target_merges=3840, max_steps_per_call=256)),
    # above vocab 4096 hist_train routes to the giant kernel
    "giant_v5120": (dict(seed=8, n_words=3000, alpha=12),
                    dict(target_merges=4864, max_steps_per_call=512)),
    "giant_unk_chunked": (dict(seed=9, n_words=3000, alpha=12, unk=98),
                          dict(target_merges=4500, unk_id=98,
                               max_steps_per_call=300)),
    "giant_rows32_n_prev": (dict(seed=10, n_words=2500, max_len=30,
                                 alpha=6),
                            dict(target_merges=4400, n_prev_merges=17)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, cuda):
    corpus_kw, kw = CASES[case]
    tokens, word_id, wc_word = _corpus(**corpus_kw)
    kw = {"unk_id": -1, "min_pair_freq": 2, **kw}
    want = bpe_hist.hist_train(tokens, word_id, wc_word, device="cpu", **kw)
    kernel = (_kernels.giant_train_step if case.startswith("giant")
              else _kernels.hist_fused_train)
    n0 = kernel.launches
    got = bpe_hist.hist_train(tokens, word_id, wc_word, device=cuda, **kw)
    assert kernel.launches > n0
    assert len(got[0]) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_trainer_on_cuda_matches_cpu(cuda, tmp_path):
    text = b"".join(b"%s hello world abracadabra %d\n" % (b"ab" * (i % 7), i)
                    for i in range(400))
    out = {}
    for dev in ("cpu", cuda):
        for engine in ("hist", "giant", "flat"):
            t = BPETrainer(target_vocab_size=330, unk_id=-1,
                           character_coverage=0.9995, min_pair_freq=2,
                           engine=engine, device=dev)
            t.load_corpus_bytes(text)
            t.train()
            mp, vp = tmp_path / "m", tmp_path / "v"
            t.save(str(mp), str(vp))
            out[str(dev), engine] = (mp.read_bytes(), vp.read_bytes())
    assert len(set(out.values())) == 1


def test_wrapper_rejects_bad_input():
    tw = torch.full((16, 512), bpe_hist.PAD, dtype=torch.int16)
    wc = torch.zeros(512, dtype=torch.int32)
    hist = torch.zeros((384, 384), dtype=torch.int32)
    kw = dict(unk=-1, min_freq=2, n_done=0, init_done=0, allowed=8,
              steps=8)
    with pytest.raises(TypeError):
        _kernels.hist_fused_train(tw.int(), wc, hist, **kw)
    with pytest.raises(ValueError, match="L must be"):
        _kernels.hist_fused_train(tw[:12].contiguous(), wc, hist, **kw)
    with pytest.raises(ValueError, match="shape"):
        _kernels.hist_fused_train(tw, wc[:100], hist, **kw)
    with pytest.raises(ValueError, match="exceed"):
        _kernels.hist_fused_train(tw, wc, hist, **{**kw, "n_done": 127,
                                                   "allowed": 2})
    recs = _kernels.hist_fused_train(tw, wc, hist, **kw)
    assert recs.shape == (8, 4) and not recs[:, 3].any()


def _layout(seed, **kw):
    return bpe_hist.build_layout(*_corpus(seed, **kw), 64)


# name: (corpus arguments, unk id, min_pair_freq, steps per call, target)
LOOP_CASES = {
    "plain": (dict(seed=20, n_words=1500), -1, 2, 16, 60),
    "unk_byte": (dict(seed=21, n_words=1500, unk=98), 98, 2, 7, 40),
    "rows32": (dict(seed=22, n_words=1200, max_len=30, alpha=4), -1, 2, 16,
               40),
    "min_freq_stop": (dict(seed=23, n_words=1500), -1, 700, 16, 80),
    "vocab1024": (dict(seed=24, n_words=3000, alpha=12), -1, 2, 128, 700),
}


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_step_loops_match_plain(case, sparse, cuda):
    """The per-merge train loops with K4 (make_train_loop: the chain of
    hist_sharded_train on one rank) or K5 (make_train_loop_sparse:
    hist_sparse_train) on the card against the same loops on the CPU
    (their plain versions), call by call: merges, counters, tokens,
    tables and presence."""
    corpus_kw, unk, minf, steps, target = LOOP_CASES[case]
    c = _layout(**corpus_kw)
    L, W = c.tw.shape
    v = -(-(256 + target) // 128) * 128
    make = (bpe_hist.make_train_loop_sparse if sparse
            else bpe_hist.make_train_loop)
    loop = make(v, L, W, target_merges=target, max_steps=steps)
    kernel = (_kernels.hist_sparse_train if sparse
              else _kernels.hist_sharded_train)
    n0 = kernel.launches
    states = []
    for dev in ("cpu", cuda):
        ts = bpe_hist.hist_train_init(c, unk, target, v, device=dev)
        pres = (torch.tensor(bpe_hist.build_presence(c.tw, v), device=dev),)
        states.append([ts, pres[:int(sparse)]])
    for _ in range(target // steps + 2):
        for st in states:
            st[0] = loop(st[0], *st[1], unk, minf)
        (tp, pp), (tk, pk) = states
        assert (tk.n_merges, tk.done) == (tp.n_merges, tp.done)
        np.testing.assert_array_equal(tk.merges, tp.merges)
        np.testing.assert_array_equal(tk.merge_freqs, tp.merge_freqs)
        assert torch.equal(tk.corpus.tw.cpu(), tp.corpus.tw)
        assert torch.equal(tk.hist.cpu(), tp.hist)
        for a, b in zip(pk, pp):
            assert torch.equal(a.cpu(), b)
    assert kernel.launches > n0 and tk.n_merges > 0
    assert tk.done == (case == "min_freq_stop")


@pytest.mark.cuda
def test_sparse_hist_train_on_cuda_matches_cpu(cuda):
    kw = dict(target_merges=200, unk_id=-1, min_pair_freq=2,
              max_steps_per_call=64)
    tokens, word_id, wc_word = _corpus(30, n_words=2500)
    want = bpe_hist.hist_train(tokens, word_id, wc_word, device="cpu",
                               sparse=True, **kw)
    got = bpe_hist.hist_train(tokens, word_id, wc_word, device=cuda,
                              sparse=True, **kw)
    dense = bpe_hist.hist_train(tokens, word_id, wc_word, device=cuda, **kw)
    for w, g, d in zip(want, got, dense):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)


def _calls(kernel, plain, states, merges, steps, start=0, **kw):
    """Drive the kernel on states[1] and its plain version on states[0]
    with the same calls of `steps` merges from merge `start`; after every
    call the records and every state tensor must be identical.  Returns
    the merges done."""
    n_done, done = start, 0
    while n_done < start + merges and not done:
        allowed = start + merges - n_done
        ckw = dict(kw, n_done=n_done, init_done=done, allowed=allowed,
                   steps=min(steps, allowed))
        want = plain(*states[0], **ckw)
        got = kernel(*states[1], **ckw)
        assert torch.equal(got.cpu(), want)
        for w, g in zip(*states):
            assert torch.equal(g.cpu(), w)
        n_new = int(want[:, 3].sum())
        done = int(n_new < ckw["steps"])
        n_done += n_new
    return n_done - start


# name: (corpus arguments, v, steps per call, merges, min_pair_freq)
HIST_CALL_CASES = {
    # equal weights: tied counts between rows and between columns
    "ties_v384_L16_steps1": (dict(seed=40, n_words=1500, alpha=4,
                                  equal_weights=True), 384, 1, 60, 2),
    # few letters: frequent pairs whose column a is many rows' maximum
    "frequent_v384_L16": (dict(seed=41, n_words=2000, alpha=3), 384, 16,
                          128, 2),
    # 'aaaa' runs: a == b
    "runs_v384_L32": (dict(seed=42, n_words=1500, max_len=30, alpha=2),
                      384, 9, 128, 2),
    # more steps per call than the grid has blocks
    "steps300_v768_L64": (dict(seed=43, n_words=2000, max_len=60, alpha=3),
                          768, 300, 512, 2),
    "min_freq_stop_v384": (dict(seed=44, n_words=1500), 384, 16, 128, 700),
    "v4096_L16": (dict(seed=45, n_words=3000, alpha=12), 4096, 512, 3840,
                  2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HIST_CALL_CASES))
def test_hist_kernel_call_by_call(case, cuda):
    """The persistent hist kernel against its plain version after every
    call: records, tokens and the table."""
    corpus_kw, v, steps, merges, minf = HIST_CALL_CASES[case]
    c = _layout(**corpus_kw)
    states = []
    for dev in ("cpu", cuda):
        tw = torch.tensor(c.tw, device=dev)
        wc = torch.tensor(c.wcount.reshape(-1), device=dev)
        states.append([tw, wc, bpe_hist.init_hist(tw, wc, -1, v)])
    n0 = _kernels.hist_fused_train.launches
    n = _calls(_kernels.hist_fused_train, _kernels.hist_fused_train_plain,
               states, merges, steps, unk=-1, min_freq=minf)
    assert _kernels.hist_fused_train.launches > n0
    assert (n == merges) == (minf == 2) and n > 0


# name: (corpus arguments, v, chunk width, steps per call, merges,
#        min_pair_freq)
GIANT_CALL_CASES = {
    # one used chunk
    "nc_used1_v1024": (dict(seed=50, n_words=400, alpha=6), 1024, 512, 16,
                       300, 2),
    # equal weights: equal bounds in different row groups; one merge a
    # call, so lim crosses group edges call by call
    "ties_v1024_steps1": (dict(seed=51, n_words=1500, alpha=4,
                               equal_weights=True), 1024, 512, 1, 80, 2),
    "runs_v1024_L32": (dict(seed=52, n_words=1500, max_len=30, alpha=2),
                       1024, 512, 64, 500, 2),
    "min_freq_stop_v1024": (dict(seed=53, n_words=1500), 1024, 512, 64, 700,
                            300),
    "v2048_cw1024": (dict(seed=54, n_words=3000, alpha=12), 2048, 1024,
                     256, 1700, 2),
    # the width giant_train takes above 1,500,000 words: 4 used chunks
    "v4096_cw2048": (dict(seed=55, n_words=7000, alpha=16), 4096, 2048,
                     256, 3000, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GIANT_CALL_CASES))
def test_giant_kernel_call_by_call(case, cuda):
    """The persistent giant kernel against its plain version after every
    call: all five record lanes (n_refresh too), tokens, table, presence
    and the row-max bounds."""
    corpus_kw, v, cw, steps, merges, minf = GIANT_CALL_CASES[case]
    lay = bpe_giant.build_giant_layout(*_corpus(**corpus_kw), v, cw=cw)
    nc_used = -(-lay.n_words // cw)
    assert (nc_used == 1) == case.startswith("nc_used1")
    states = []
    for dev in ("cpu", cuda):
        tw = torch.tensor(lay.tw, device=dev)
        wc = torch.tensor(lay.wc.reshape(-1), device=dev)
        hist, rowmax = bpe_giant.init_tables(tw, wc, -1, v)
        states.append([tw, wc, hist, torch.tensor(lay.presT, device=dev),
                       rowmax])
    n0 = _kernels.giant_train_step.launches
    n = _calls(_kernels.giant_train_step, _kernels.giant_train_step_plain,
               states, merges, steps, unk=-1, min_freq=minf,
               nc_used=nc_used)
    assert _kernels.giant_train_step.launches > n0
    assert (n == merges) == (minf == 2) and n > 0


@pytest.fixture
def nccl_world1(cuda):
    """A one-rank NCCL process group on the card for the sharded chain."""
    import socket

    import torch.distributed as dist

    from shredword_tpu_torch.parallel import multihost

    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"tcp://localhost:{port}", world_size=1, rank=0)
    yield dist
    dist.destroy_process_group()


# the call-by-call cases of the K4/K5 loops: HIST_CALL_CASES at v <= 1024
CHAIN_CALL_CASES = {
    **{k: c for k, c in HIST_CALL_CASES.items() if c[1] <= 768},
    "v1024_L16": (dict(seed=46, n_words=3000, alpha=12), 1024, 128, 700, 2),
}


def _table_calls(kernel, plain, states, merges, steps, **kw):
    """_calls for the hist-table wrappers, checking after every call the
    kernel's rows (max, arg) against the plain recomputation from its
    table too."""
    hist = states[1][2]
    rowmax = torch.empty(2 * hist.shape[0], dtype=torch.int32,
                         device=hist.device)

    def checked(*state, **ckw):
        recs = kernel(*state, rowmax=rowmax, **ckw)
        assert torch.equal(rowmax, _kernels.table_rowmax_plain(hist))
        return recs

    return _calls(checked, plain, states, merges, steps, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["sparse", "sharded_nccl1"])
@pytest.mark.parametrize("case", sorted(CHAIN_CALL_CASES))
def test_step_kernels_call_by_call(case, chain, cuda, request):
    """The K5 loop (hist_sparse_train) and the K4 chain (hist_sharded_train
    with an all_reduce over a one-rank NCCL group) against their plain
    versions after every call: records, tokens, table, presence and the
    rows' (max, arg)."""
    corpus_kw, v, steps, merges, minf = CHAIN_CALL_CASES[case]
    c = _layout(**corpus_kw)
    states = []
    for dev in ("cpu", cuda):
        tw = torch.tensor(c.tw, device=dev)
        wc = torch.tensor(c.wcount.reshape(-1), device=dev)
        states.append([tw, wc, bpe_hist.init_hist(tw, wc, -1, v)])
        if chain == "sparse":
            states[-1].append(torch.tensor(bpe_hist.build_presence(c.tw, v),
                                           device=dev))
    if chain == "sparse":
        kernel, plain = _kernels.hist_sparse_train, \
            _kernels.hist_sparse_train_plain
        kw = {}
    else:
        dist = request.getfixturevalue("nccl_world1")
        kernel, plain = _kernels.hist_sharded_train, \
            _kernels.hist_sharded_train_plain
        kw = dict(reduce=dist.all_reduce)
    n0 = kernel.launches

    def run(*state, **ckw):
        return kernel(*state, **kw, **ckw)

    n = _table_calls(run, plain, states, merges, steps, unk=-1,
                     min_freq=minf)
    assert kernel.launches > n0
    assert (n == merges) == (minf == 2) and n > 0


# name: (corpus arguments, v, steps per call, merges, min_pair_freq, unk)
SHARDED_GIANT_CASES = {
    # equal weights: tied bounds and counts; one merge a call
    "ties_v384_steps1": (dict(seed=60, n_words=1500, alpha=4,
                              equal_weights=True), 384, 1, 60, 2, -1),
    # 'aaaa' runs: a == b
    "runs_v1024_L32": (dict(seed=61, n_words=1500, max_len=30, alpha=2),
                       1024, 64, 500, 2, -1),
    "unk_v2048": (dict(seed=62, n_words=3000, alpha=12, unk=98), 2048, 256,
                  1500, 2, 98),
    "min_freq_stop_v1024": (dict(seed=63, n_words=1500), 1024, 64, 700,
                            300, -1),
    # the int16-crossing resume of tests/test_giant_64k_envelope.py
    # (merges 32510-32524, ids past 32767), on the own rows [30976, v)
    # that hold every pair of its words
    "int16_resume_v32896": (None, 32896, 5, 14, 2, -1),
    # the same at the top of vocab 65536 (merges 65260-65273, new ids to
    # 65529), on the own rows [64896, 65536)
    "top_resume_v65536": (None, 65536, 5, 14, 2, -1),
}
TOP_N_PREV = 65260


def _top_corpus():
    """Two 8-token chain words near vocab 65536 (counts 100 and 50)."""
    tokens = np.concatenate([np.arange(65000, 65008, dtype=np.int32),
                             np.arange(65100, 65108, dtype=np.int32)])
    word_id = np.repeat(np.arange(2, dtype=np.int32), 8)
    return tokens, word_id, np.asarray([100, 50], np.int32)
G1_CW = 256       # chunk width: several chunks on these corpora


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["none", "nccl1"])
@pytest.mark.parametrize("case", sorted(SHARDED_GIANT_CASES))
def test_sharded_giant_kernel_call_by_call(case, reduce, cuda, request):
    """The row-sharded giant step (G1, giant_sharded_train) on one rank's
    chunked layout against its plain version after every call: all five
    record lanes, tokens, the table, the row bounds and the presence; no
    reduce: one persistent launch a call; the reduces over a one-rank
    NCCL group: 2 * steps + 1 launches a call."""
    from torch_dist_workers import ENVELOPE_N_PREV, envelope_corpus

    from shredword_tpu_torch.parallel import giant as par_giant
    from shredword_tpu_torch.parallel import hist as par_hist

    corpus_kw, v, steps, merges, minf, unk = SHARDED_GIANT_CASES[case]
    start, base = 0, 0
    if corpus_kw is None:
        resumed = {"int16_resume_v32896": (
            lambda: envelope_corpus()[:3], ENVELOPE_N_PREV, 30976, 32767),
            "top_resume_v65536": (_top_corpus, TOP_N_PREV, 64896, 65519)}
        make, start, base, past = resumed[case]
        tokens, word_id, counts = make()
        assert tokens.min() >= base
    else:
        tokens, word_id, counts = _corpus(**corpus_kw)
    c = par_hist.shard_layout(tokens, word_id, counts, 1, dtype=np.int32)
    lay = par_giant.rank_layout(par_hist.local_shard(c, 0, 1), v, cw=G1_CW)
    states = []
    for dev in ("cpu", cuda):
        tw = torch.tensor(lay.tw, device=dev)
        wc = torch.tensor(lay.wc.reshape(-1), device=dev)
        states.append([tw, wc, *par_giant.init_row_shard(
            tw, wc, unk, v, base, v - base),
            torch.tensor(lay.presT, device=dev)])
    kw = dict(base=base, nc_used=-(-lay.n_words // G1_CW))
    reduces = {}
    if reduce == "nccl1":
        dist = request.getfixturevalue("nccl_world1")
        reduces = dict(reduce_key=lambda k: dist.all_reduce(
            k, op=dist.ReduceOp.MAX), reduce_deltas=dist.all_reduce)
    kernel = _kernels.giant_sharded_train
    calls, recs = [], []

    def run(*state, **ckw):
        n0 = kernel.launches
        recs.append(kernel(*state, **reduces, **kw, **ckw))
        calls.append((kernel.launches - n0, ckw["steps"]))
        return recs[-1]

    def plain(*state, **ckw):
        return _kernels.giant_sharded_train_plain(*state, **kw, **ckw)

    n = _calls(run, plain, states, merges, steps, start=start, unk=unk,
               min_freq=minf)
    per_call = (lambda s: 1) if reduce == "none" else (lambda s: 2 * s + 1)
    assert all(k == per_call(s) for k, s in calls) and calls
    assert (n == merges) == (minf == 2) and n > 0
    if corpus_kw is None:
        done = torch.cat(recs).cpu()
        assert bool((done[done[:, 3] == 1, :2] > past).any())


# ---------------------------------------------------------------------
# the encoder (csrc/encode.cu)
# ---------------------------------------------------------------------

# name: (v, n_long): the dense table below vocab 4097, the hash table
# above; chunks over 64 bytes take the kernel's global-memory mode; past
# vocab 32768 the merges of high_id_merges on letters a-h: ids past
# 32767 in int16 storage up to 65536, int32 ids past 65535 above it
ENCODE_CASES = {"dense_v300": (300, 0), "dense_v768_long": (768, 12),
                "dense_v4096": (4096, 0), "hash_v5000_long": (5000, 12),
                "hash_v65536_wrap": (65536, 0),
                "hash_v131072_int32": (131072, 12)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_kernel_matches_plain(case, cuda):
    v, n_long = ENCODE_CASES[case]
    high = v > 32768
    merges = (high_id_merges if high else random_merges)(v, v - 256)
    flat, lens = random_chunks(v + 1, 3000, alpha=8 if high else 6,
                               n_long=n_long)
    tables = {dev: (encode_ops.build_rank_table(merges, v, dev)
                    if v <= encode_ops.DENSE_V_MAX
                    else encode_ops.build_merge_table(merges, dev))
              for dev in ("cpu", cuda)}
    out = {}
    for dev in ("cpu", cuda):
        n0 = encode_ops.encode_core.launches
        out[dev] = encode_ops.encode_core(
            torch.from_numpy(flat).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev), tables[dev],
            v=v)
        assert encode_ops.encode_core.launches - n0 == (2 if dev == cuda
                                                        else 0)
    (ip, cp), (ik, ck) = out["cpu"], out[cuda]
    assert ik.dtype == ip.dtype == encode_ops.out_dtype(v)
    torch.testing.assert_close(ck.cpu(), cp, rtol=0, atol=0)
    torch.testing.assert_close(ik.cpu(), ip, rtol=0, atol=0)
    assert len(ip) < len(flat) * 0.9                   # merges fired
    if high:                        # the ids past 32767 (and 65535) fired
        ids = encode_ops.ids_to_numpy(ip)
        assert ids.max() == v - 1 and (ids == 32771).any()
    lookups = torch.zeros(1, dtype=torch.int64, device=cuda)
    encode_ops.encode_core(torch.from_numpy(flat).to(cuda),
                           torch.from_numpy(lens.astype(np.int32)).to(cuda),
                           tables[cuda], v=v, lookups=lookups)
    assert int(lookups) >= int((lens - 1).sum())


def _edge_case(case):
    """(flat, lens, merges) of a length-class edge case: the shared ones,
    a stream with no chunk over one byte (and empty chunks), and one with
    every chunk over 64 bytes."""
    if case in ("one_byte", "all_long"):
        merges = random_merges(31, 500)
        if case == "all_long":
            return (*random_chunks(32, 0, n_long=60), merges)
        lens = np.random.RandomState(33).randint(0, 2, 5000)
        return (np.frombuffer(b"ab" * 5000, np.uint8)[:lens.sum()].copy(),
                lens, merges)
    return boundary_cases()[case]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "hash"])
@pytest.mark.parametrize("case", sorted(boundary_cases())
                         + ["one_byte", "all_long"])
def test_encode_kernel_length_class_edges(case, kind, cuda):
    """E1 against its plain versions on the edges of its length classes
    (tests/torch_encode_cases.py), on one-byte chunks only and on chunks
    over 64 bytes only, with the dense and the hash table; the lookups
    the kernel counts are one per pair of a chunk at least."""
    flat, lens, merges = _edge_case(case)
    v = 256 + len(merges)
    out = {}
    for dev in ("cpu", cuda):
        table = (encode_ops.build_rank_table(merges, v, dev)
                 if kind == "dense"
                 else encode_ops.build_merge_table(merges, dev))
        args = (torch.from_numpy(flat).to(dev),
                torch.from_numpy(lens.astype(np.int32)).to(dev), table)
        n0 = encode_ops.encode_core.launches
        out[dev] = encode_ops.encode_core(*args, v=v)
        assert encode_ops.encode_core.launches - n0 == (2 if dev == cuda
                                                        else 0)
    (ip, cp), (ik, ck) = out["cpu"], out[cuda]
    torch.testing.assert_close(ck.cpu(), cp, rtol=0, atol=0)
    torch.testing.assert_close(ik.cpu(), ip, rtol=0, atol=0)
    lookups = torch.zeros(1, dtype=torch.int64, device=cuda)
    encode_ops.encode_core(*args, v=v, lookups=lookups)
    assert int(lookups) >= int(np.maximum(lens - 1, 0).sum())
    if case == "one_byte":
        assert int(lookups) == 0 and torch.equal(cp, torch.from_numpy(
            lens.astype(np.int32)))


@pytest.mark.cuda
def test_tokenizer_on_cuda_matches_cpu(cuda):
    merges = random_merges(7, 600, alpha=26)
    rng = np.random.RandomState(8)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, k))
             for k in rng.randint(1, 12, 3000)]
    text = " ".join(words) + "\n" + "x" * 150 + " aaaa aaa  \t fhus"
    docs = [text[i:i + 4000] for i in range(0, len(text), 4000)]
    for pattern in ("", "gpt", "word"):
        want = Tokenizer(merges, pattern=pattern, backend="cpu")
        tok = Tokenizer(merges, pattern=pattern, device=cuda)
        n0 = encode_ops.encode_core.launches
        ids = tok.encode_array(text)
        assert encode_ops.encode_core.launches - n0 == 2    # one call
        np.testing.assert_array_equal(ids, want.encode_array(text))
        assert tok.decode(ids) == text
        batch = tok.encode_batch_arrays(docs)
        for d, got in zip(docs, batch):
            np.testing.assert_array_equal(got, want.encode_array(d))
    assert Tokenizer(FHUS, device=cuda).encode("fhus") == [102, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("v", [768, 16028])
def test_stream_windows_on_cuda_match_one_call(v, cuda, monkeypatch):
    """encode_stream in windows of 64 KB on the card (two E1 launches a
    window) == one call over the whole stream == the native CPU encoder,
    with documents that span windows, for the dense and the hash
    table."""
    merges = random_merges(v, v - 256, alpha=26)
    rng = np.random.RandomState(9)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, k))
             for k in rng.randint(1, 12, 120000)]
    text = " ".join(words) + "\n" + "y" * 70000 + " end"
    docs = [text[i:i + 50000] for i in range(0, len(text), 50000)]
    tok = Tokenizer(merges, device=cuda)
    one = tok.encode_array(text)
    one_b = tok.encode_batch_arrays(docs)
    window = 1 << 16
    monkeypatch.setattr(encode_ops, "STREAM_WINDOW_BYTES", window)
    lens = encode_ops.ws_chunk_lens(np.frombuffer(text.encode(), np.uint8))
    n_win = len(encode_ops.stream_windows(lens)) - 1
    assert n_win > len(text) // window
    n0 = encode_ops.encode_core.launches
    ids = tok.encode_array(text)
    assert encode_ops.encode_core.launches - n0 == 2 * n_win
    np.testing.assert_array_equal(ids, one)
    np.testing.assert_array_equal(
        ids, Tokenizer(merges, backend="cpu").encode_array(text))
    for got, want in zip(tok.encode_batch_arrays(docs), one_b):
        np.testing.assert_array_equal(got, want)
    assert tok.decode(ids) == text


# ---------------------------------------------------------------------
# the Unigram lattice kernels (csrc/unigram.cu)
# ---------------------------------------------------------------------

def _lattice_on(dev, case):
    table, wlen, wcount, logp = (overflow_lattice() if case == "overflow"
                                 else random_lattice(case))
    dt = unigram_ops.make_device_table(table, wlen, wcount, dev)
    return (dt.ids, torch.from_numpy(logp.astype(np.float32)).to(dev),
            dt.wlen, dt.wcount)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LATTICES) + ["overflow"])
def test_unigram_kernels_match_plain(case, cuda):
    """U1 within rtol=1e-5, atol=1e-6 of its plain version (both sum in
    float64; their float32 log-sum-exps sum in other orders) and its
    log-likelihood within 1e-6 relative; U2 identical.  "long_l70" runs
    the kernels' global-scratch mode; "overflow" U1's overflowed
    posteriors (counted as 1)."""
    cpu = _lattice_on("cpu", case)
    dev = _lattice_on(cuda, case)
    n0 = (unigram_ops.fb_core.launches, unigram_ops.viterbi_core.launches)
    counts, ll = unigram_ops.fb_core(*dev)
    want_c, want_ll = unigram_ops.fb_core_plain(*cpu)
    torch.testing.assert_close(counts.cpu(), want_c, rtol=1e-5, atol=1e-6)
    assert abs(float(ll) - float(want_ll)) <= 1e-6 * abs(float(want_ll))
    got = unigram_ops.viterbi_core(*dev[:3])
    want = unigram_ops.viterbi_core_plain(*cpu[:3])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    _, _, final = unigram_ops.viterbi_core(*dev[:3], backtrace=False)
    assert torch.equal(final, got[2])
    assert (unigram_ops.fb_core.launches - n0[0],
            unigram_ops.viterbi_core.launches - n0[1]) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "rows32", "long_l70"])
def test_unigram_fb_with_any_hot_ids(case, cuda):
    """U1 with no hot ids, a few and the table's own (every id's count
    in shared memory or straight in global memory) agrees with its plain
    version as in test_unigram_kernels_match_plain, and so does a map
    with slots outside [0, H) (counted as none) and hot ids outside
    [0, n) (never added)."""
    cpu = _lattice_on("cpu", case)
    dev = _lattice_on(cuda, case)
    want_c, want_ll = unigram_ops.fb_core_plain(*cpu)
    n = dev[1].shape[0]
    slot = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    slot[3], slot[5], slot[9] = 2, 7, -5
    odd = unigram_ops.HotIds(
        torch.tensor([n + 5, -1, 3], dtype=torch.int32, device=cuda), slot)
    for hot in [unigram_ops.hot_ids(dev[0], h)
                for h in (0, 7, unigram_ops.HOT_IDS)] + [odd]:
        counts, ll = unigram_ops.fb_core(*dev, hot=hot)
        torch.testing.assert_close(counts.cpu(), want_c, rtol=1e-5,
                                   atol=1e-6)
        assert abs(float(ll) - float(want_ll)) <= 1e-6 * abs(float(want_ll))


@pytest.mark.cuda
def test_unigram_overflow_corpus_on_cuda(cuda, tmp_path):
    """Training reaches words split only through pruned pieces: U1 gives
    a finite model that encodes its corpus, with the pieces of the plain
    versions' run."""
    (tmp_path / "c.txt").write_text(OVERFLOW_TEXT)
    out = {}
    for dev in ("cpu", cuda):
        t = UnigramTrainer(**OVERFLOW_CONFIG, device=dev)
        t.load_corpus(str(tmp_path / "c.txt"))
        t.train()
        assert np.isfinite(t.log_probs).all() and np.isfinite(t.final_ll)
        out[str(dev)] = t
    a, b = out.values()
    assert a.pieces == b.pieces
    np.testing.assert_allclose(a.log_probs, b.log_probs, rtol=1e-5,
                               atol=1e-5)
    b.save(str(tmp_path / "u.model"))
    tok = UnigramTokenizer.load(str(tmp_path / "u.model"), device=cuda)
    assert tok.decode(tok.encode_array(OVERFLOW_TEXT)) \
        == OVERFLOW_TEXT.lower()


@pytest.mark.cuda
def test_unigram_trainer_on_cuda_matches_cpu(cuda, tmp_path):
    rng = np.random.RandomState(11)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 8, k))
             for k in rng.randint(1, 14, 4000)]
    (tmp_path / "c.txt").write_text(" ".join(words))
    out = {}
    for dev in ("cpu", cuda):
        t = UnigramTrainer(target_vocab_size=200, seed_size=2000,
                           max_word_len=16, device=dev)
        t.load_corpus(str(tmp_path / "c.txt"))
        n0 = unigram_ops.fb_core.launches
        assert t.train() == 200
        out[str(dev)] = t
        assert (unigram_ops.fb_core.launches > n0) == (dev == cuda)
    a, b = out.values()
    assert a.pieces == b.pieces
    np.testing.assert_allclose(a.log_probs, b.log_probs, rtol=1e-5,
                               atol=1e-5)
    a.save(str(tmp_path / "u.model"))
    text = " ".join(words[:500]) + " " + "ab" * 40
    ids = {str(d): UnigramTokenizer.load(str(tmp_path / "u.model"),
                                         device=d).encode_array(text)
           for d in ("cpu", cuda)}
    np.testing.assert_array_equal(*ids.values())


# ---------------------------------------------------------------------
# the GPT splitter (csrc/pretok.cu)
# ---------------------------------------------------------------------

@pytest.mark.cuda
def test_gpt_splitter_kernel_matches_plain(cuda):
    """P1's mask equals its plain version's on the splitter's seeded
    inputs (cases, fuzz strings, long runs across tiles and their edges),
    two launches a call, and the device splitter's starts equal the host
    splitter's."""
    table = pretok_ops.class_table()
    for s in all_inputs():
        cp = code_points(s)
        cls = torch.from_numpy(table[cp].astype(np.int8))
        padded = torch.cat([cls, torch.full((5,), 16, dtype=torch.int8)])
        n0 = pretok_ops.gpt_starts_mask.launches
        got = pretok_ops.gpt_starts_mask(padded.to(cuda), len(cp))
        assert pretok_ops.gpt_starts_mask.launches - n0 == 2
        want = pretok_ops.gpt_starts_mask_plain(padded, len(cp))
        assert torch.equal(got.cpu(), want), repr(s[:40])
        np.testing.assert_array_equal(
            pretok_ops.gpt_starts_device(cp, device=cuda),
            pretok_ops.gpt_starts(cp))
    empty = torch.full((4,), 16, dtype=torch.int8, device=cuda)
    assert not pretok_ops.gpt_starts_mask(empty, 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, pretok_ops.GPT_TILE - 1,
                               pretok_ops.GPT_TILE + 1])
def test_gpt_splitter_kernel_tile_edges(n, cuda):
    """P1 at one position (each class) and one under and one over a tile,
    on seeded random classes, with a padded tail: the mask equals its
    plain version's, two launches a call."""
    rng = np.random.RandomState(n)
    inputs = ([np.array([c], np.int8) for c in range(16)] if n == 1
              else [rng.randint(0, 16, n).astype(np.int8),
                    rng.choice([1, 2, 4, 5, 6], n).astype(np.int8)])
    for cls in inputs:
        padded = torch.from_numpy(np.concatenate(
            [cls, np.full(7, 16, np.int8)]))
        n0 = pretok_ops.gpt_starts_mask.launches
        got = pretok_ops.gpt_starts_mask(padded.to(cuda), n)
        assert pretok_ops.gpt_starts_mask.launches - n0 == 2
        assert torch.equal(got.cpu(),
                           pretok_ops.gpt_starts_mask_plain(padded, n))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [7, 64])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_kernel_call_by_call(case, steps, cuda):
    """F1 against its plain version (bpe_ops.train_loop on the CPU) after
    every call of `steps` merges: merges, frequencies, the merge count,
    done and the compacted stream identical; one launch a call that has
    a merge to make, none for a call past the end."""
    corpus_kw, target, n_prev, unk, minf = FLAT_CASES[case]
    arrays = flat_corpus(**corpus_kw)
    want, got = (bpe_ops.train_init(bpe_ops.make_state(*arrays, device=d),
                                    target, n_prev_merges=n_prev)
                 for d in ("cpu", cuda))
    n0, calls = _kernels.flat_train.launches, 0
    kw = dict(target_merges=target, max_steps=steps)
    while not want.done and want.n_merges < target:
        want = _kernels.flat_train_plain(want, unk, minf, **kw)
        got = _kernels.flat_train(got, unk, minf, **kw)
        calls += 1
        assert (got.n_merges, got.done) == (want.n_merges, want.done)
        np.testing.assert_array_equal(got.merges, want.merges)
        np.testing.assert_array_equal(got.merge_freqs, want.merge_freqs)
        for g, w in zip(bpe_ops.final_corpus(got.corpus), want.corpus):
            assert torch.equal(g.cpu(), w)
    assert _kernels.flat_train.launches - n0 == calls
    assert got.corpus.pres.shape[0] == max(256 + target,
                                           int(arrays[0].max()) + 1)
    assert want.done == (case in ("min_freq_stop", "to_one_token",
                                  "long_tail", "late_edge_pair",
                                  "reserve_131328_rows"))
    assert want.n_merges > n_prev
    if case == "to_one_token":              # every word is one token
        assert bool((got.corpus.len == 1).all())
    again = _kernels.flat_train(got, unk, minf, **kw)
    assert _kernels.flat_train.launches - n0 == calls
    assert (again.n_merges, again.done) == (got.n_merges, got.done)


@pytest.mark.cuda
def test_flat_trainer_on_cuda_matches_cpu(cuda, tmp_path):
    """The long-word route through BPETrainer on the card (F1, one launch
    per call of merges_per_device_call merges) and on the CPU (its plain
    version): the same bytes."""
    path = str(tmp_path / "long.txt")
    make_long_corpus(path, raw_mb=0.05)
    out = {}
    for dev in ("cpu", cuda):
        n0 = _kernels.flat_train.launches
        t = BPETrainer(640, 0, 0.995, 2, device=dev)
        t.load_corpus(path)
        assert t.train() == 384
        launches = _kernels.flat_train.launches - n0
        assert launches == (6 if dev == cuda else 0)
        mp, vp = tmp_path / "m", tmp_path / "v"
        t.save(str(mp), str(vp))
        out[str(dev)] = (mp.read_bytes(), vp.read_bytes())
    assert out["cpu"] == out[str(cuda)]


# ---------------------------------------------------------------------
# the sharded flat loop S1 (csrc/flat_sharded.cu at world > 1, F1 alone)
# ---------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("group", ["none", "nccl1"])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_sharded_world1_call_by_call(case, group, cuda, request,
                                          monkeypatch):
    """S1 of a rank alone (no group, and a one-rank NCCL group) against
    its plain version after every call of 64 merges: records, the merge
    count, done and the compacted stream identical; one launch (F1's) a
    call with merges to make, none past the end; bpe_ops.pair_counts
    never called on the card, nor any collective (the state is built
    through F1's call alone)."""
    import torch.distributed as dist

    g = (request.getfixturevalue("nccl_world1").group.WORLD
         if group == "nccl1" else None)
    collectives = []
    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, lambda *a, _n=name, **k:
                            collectives.append(_n))
    corpus_kw, target, n_prev, unk, minf = FLAT_CASES[case]
    arrays = flat_corpus(**corpus_kw)
    want, got = (bpe_ops.train_init(bpe_ops.make_state(*arrays, device=d),
                                    target, n_prev_merges=n_prev)
                 for d in ("cpu", cuda))
    counted = []
    pair_counts = bpe_ops.pair_counts
    kw = dict(target_merges=target, max_steps=64)
    n0, calls = _kernels.flat_sharded_train.launches, 0
    while not want.done and want.n_merges < target:
        want = _kernels.flat_sharded_train(want, unk, minf, group=g, **kw)
        bpe_ops.pair_counts = lambda *a: counted.append(a)
        try:
            got = _kernels.flat_sharded_train(got, unk, minf, group=g, **kw)
        finally:
            bpe_ops.pair_counts = pair_counts
        calls += 1
        assert (got.n_merges, got.done) == (want.n_merges, want.done)
        np.testing.assert_array_equal(got.merges, want.merges)
        np.testing.assert_array_equal(got.merge_freqs, want.merge_freqs)
        for x, y in zip(bpe_ops.final_corpus(got.corpus), want.corpus):
            assert torch.equal(x.cpu(), y)
    assert _kernels.flat_sharded_train.launches - n0 == calls > 0
    assert not counted and not collectives
    _kernels.flat_sharded_train(got, unk, minf, group=g, **kw)
    assert _kernels.flat_sharded_train.launches - n0 == calls


S1_TEST_ROWS = 16     # the chain test's rows a list: the fallback fires


@pytest.mark.cuda
def test_flat_sharded_chain_two_gloo_ranks(cuda, tmp_path):
    """S1's chain (launch A, launch M, the exchange) in 2 gloo ranks on
    one card against its plain version, call by call on every stream of
    tests/torch_flat_cases.py (torch_dist_workers.s1_calls), with 16 rows
    a list in the exchange, so that longer lists take the fallback:
    records, merge count, done and the span's compacted stream identical
    after every call on each rank, the same merges and the same
    fallbacks on both ranks (every rank picks the same pair and halts
    alike), the fallback taken, the launches exactly those the calls
    plan, two a merge, and two for each merge a fallback runs again
    (torch_dist_workers.chain_launches), none past the end, and
    bpe_ops.pair_counts called once a run (the start), never per merge,
    also through parallel.train.sharded_train (its default rows)."""
    import torch_dist_workers as workers

    ranks = workers.run_ranks(workers.s1_calls, 2, str(tmp_path),
                              str(cuda), 64, None, S1_TEST_ROWS,
                              timeout=900)
    fell_back = 0
    for case in [*FLAT_CASES, "sharded_train"]:
        r0, r1 = ranks[0][case], ranks[1][case]
        for r in (r0, r1):
            assert r["same"], case
            n = len(r["merges"])
            assert n > 0 and r["calls"] > 0
            assert r["launches"] == r["expected"] >= 2 * n, case
            assert r["past_end"] == 0 and r["pair_counts"] == 1, case
        np.testing.assert_array_equal(r0["merges"], r1["merges"])
        if case != "sharded_train":
            assert r0["fallbacks"] == r1["fallbacks"], case
            assert r0["rows"] == r1["rows"] >= S1_TEST_ROWS, case
            fell_back += len(r0["fallbacks"])
    assert fell_back > 0


@pytest.mark.cuda
def test_flat_sharded_compact_lists_are_exact(cuda, tmp_path):
    """Launch M's compact list in 2 gloo ranks on one card, merge by
    merge on every stream of tests/torch_flat_cases.py
    (torch_dist_workers.s1_lists): its header and rows == bpe_ops
    .sum_by_key of the span's pair counts before and after the merge
    (zeros and (a, b) left out), the rows listed over the run == those,
    and the records == the plain version's."""
    import torch_dist_workers as workers

    ranks = workers.run_ranks(workers.s1_lists, 2, str(tmp_path),
                              str(cuda), timeout=900)
    for case in FLAT_CASES:
        for r in (ranks[0][case], ranks[1][case]):
            assert r["same"] and r["merges"] > 0, case
            assert r["wrong"] == [], case
            assert r["listed"] == r["exact"], case


@pytest.mark.cuda
def test_flat_sharded_start_builds(cuda, tmp_path):
    """The reproducer of a device-side index assert once seen in
    bpe_ops.FlatState's build on S1's path (every -k flat_sharded test
    and chip_smoke.py's phase 24 failed in two fresh processes; it did
    not recur in later fresh processes): in 2 gloo ranks sharing the
    card, three times on every stream of tests/torch_flat_cases.py,
    each rank's span read back and checked, train.initial_deltas over
    the group, then the FlatState, each step synchronised; every build
    == the one on the CPU (torch_dist_workers.s1_builds)."""
    import torch_dist_workers as workers

    ranks = workers.run_ranks(workers.s1_builds, 2, str(tmp_path),
                              str(cuda), 3, timeout=600)
    for case in FLAT_CASES:
        for r in ranks:
            assert r[case]["builds"] == 3 and r[case]["wrong"] == [], case


@pytest.mark.cuda
def test_flat_sharded_trainer_nccl1_matches_cpu(cuda, nccl_world1, tmp_path):
    """BPETrainer(mesh=<one-rank NCCL group>) on long words (the sharded
    flat route: words over 64 tokens) gives the bytes of the trainer on
    the CPU, with one S1 launch a call of max_steps_per_call (256)
    merges and no bpe_ops.pair_counts on the card."""
    from shredword_tpu_torch.parallel import multihost

    path = str(tmp_path / "long.txt")
    make_long_corpus(path, raw_mb=0.05)
    out = {}
    pair_counts = bpe_ops.pair_counts
    for dev in ("cpu", cuda):
        counted = []
        n0 = _kernels.flat_sharded_train.launches
        mesh = multihost.global_mesh() if dev == cuda else None
        t = BPETrainer(640, 0, 0.995, 2, device=dev, mesh=mesh)
        t.load_corpus(path)
        if dev == cuda:
            bpe_ops.pair_counts = lambda *a: counted.append(a)
        try:
            assert t.train() == 384
        finally:
            bpe_ops.pair_counts = pair_counts
        launches = _kernels.flat_sharded_train.launches - n0
        assert launches == (2 if dev == cuda else 0)
        assert not counted
        mp, vp = tmp_path / "m", tmp_path / "v"
        t.save(str(mp), str(vp))
        out[str(dev)] = (mp.read_bytes(), vp.read_bytes())
    assert out["cpu"] == out[str(cuda)]


class _FailingLib:
    """A kernel library whose launches fail."""

    def __getattr__(self, name):
        if name == "shred_cuda_error_string":
            return lambda rc: b"refused"
        return lambda *args: 98            # cudaErrorInvalidDeviceFunction


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["build", "launch"])
def test_flat_sharded_failure_raises(fault, cuda, monkeypatch):
    """A build or launch failure of S1 raises; nothing falls back to the
    plain version (no merge made, no launch counted)."""
    def no_build(*args, **kw):
        raise RuntimeError("CUDA kernel build failed: refused")

    if fault == "build":
        monkeypatch.setattr(_kernels, "_lib", None)
        monkeypatch.setattr(_kernels, "build", no_build)
    else:
        monkeypatch.setattr(_kernels, "lib", lambda: _FailingLib())
    ckw, target, n_prev, unk, minf = FLAT_CASES["long_words"]
    ts = bpe_ops.train_init(bpe_ops.make_state(*flat_corpus(**ckw),
                                               device=cuda), target)
    n0 = _kernels.flat_sharded_train.launches
    with pytest.raises(RuntimeError, match="refused"):
        _kernels.flat_sharded_train(ts, unk, minf, target_merges=target,
                                    max_steps=64)
    assert _kernels.flat_sharded_train.launches == n0
    assert ts.n_merges == 0


# ---------------------------------------------------------------------
# checkpoint and resume on the card (tests/torch_resume_cases.py; the
# CPU's runs against the JAX package are tests/test_torch_resume.py)
# ---------------------------------------------------------------------

@pytest.fixture
def resume_corpora(tmp_path):
    zipf = tmp_path / "zipf.txt"
    zipf.write_text(zipf_corpus())
    long = str(tmp_path / "long.txt")
    make_long_corpus(long, raw_mb=0.05)
    return {"zipf": str(zipf), "long": long}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", sorted(WRITTEN))
def test_resume_on_cuda_matches_cpu(engine, cuda, resume_corpora, tmp_path):
    """A run on the card with checkpoint_every 100 writes the checkpoints
    WRITTEN lists, each a prefix of the same run with device="cpu", and
    saves its bytes; a fresh trainer on the card resumed from each saves
    the CPU run's bytes and token frequencies, and launches the engine's
    kernel in its train() (none after a checkpoint that holds every
    merge).  Tolerance: exact."""
    path, d = resume_corpora["zipf"], str(tmp_path)
    cpu = trainer(CFG, path, engine)
    assert cpu.train() == MERGES
    want = outputs(cpu, d, "cpu")
    kernel = getattr(_kernels, KERNEL[engine])
    n0 = kernel.launches
    t, n, files = checkpointed(CFG, path, d, engine, cuda)
    assert n == MERGES and kernel.launches > n0
    assert outputs(t, d, "card") == want
    assert [m for m, _ in files] == list(WRITTEN[engine])
    for m, ck in files:
        assert is_prefix(ck, want[0], want[1])
        n0 = kernel.launches
        t, held, added = resumed(CFG, path, ck, engine, cuda)
        assert (held, added) == (m, MERGES - m)
        assert (kernel.launches > n0) == (m < MERGES)
        assert outputs(t, d, f"resumed{m}") == want


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["to_sharded", "to_single"])
@pytest.mark.parametrize("engine", sorted(SHARDED))
def test_resume_sharded_nccl1_matches_cpu(engine, direction, cuda,
                                          nccl_world1, resume_corpora,
                                          tmp_path):
    """Over a one-rank NCCL group on the card: a single-device checkpoint
    written mid-run on the card (checkpoint_every 50) resumed by
    BPETrainer(mesh=...) through the sharded hist engine (K4's chain),
    the row-sharded giant engine (G1) and the sharded flat engine (S1),
    each launched; and a sharded train(max_merges=150) saved with
    save_checkpoint, resumed on one device of the card.  Either way the
    bytes and token frequencies of the uninterrupted run with
    device="cpu".  Tolerance: exact."""
    from shredword_tpu_torch.parallel import multihost

    cfg, corpus = SHARDED[engine]
    path, d = resume_corpora[corpus], str(tmp_path)
    cpu = trainer(cfg, path)
    total = cpu.train()
    want = outputs(cpu, d, "cpu")
    mesh = multihost.global_mesh()
    if direction == "to_sharded":
        _, _, files = checkpointed(cfg, path, d, device=cuda, every=50)
        n, ck = files[0]
        kernel = getattr(_kernels, SHARDED_KERNEL[engine])
        n0 = kernel.launches
        t, held, added = resumed(cfg, path, ck, device=cuda, mesh=mesh)
        assert held == n and kernel.launches > n0
    else:
        # 256 + 150 ids: the sharded hist engine at vocab 4608 too
        took = "hist" if engine == "giant" else engine
        kernel = getattr(_kernels, SHARDED_KERNEL[took])
        n, n0 = 150, kernel.launches
        half = trainer(cfg, path, device=cuda, mesh=mesh)
        assert half.train(max_merges=n) == n and kernel.launches > n0
        ck = str(tmp_path / "sharded.ckpt")
        half.save_checkpoint(ck)
        assert is_prefix(ck, want[0], want[1])
        t, held, added = resumed(cfg, path, ck, device=cuda)
        assert held == n
    assert added == total - n
    assert outputs(t, d, "resumed") == want
