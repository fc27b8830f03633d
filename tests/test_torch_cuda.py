"""The port's CUDA kernels against their plain PyTorch versions.

These tests import no JAX, so they also run where only PyTorch is
installed.  The ``cuda`` ones need a card and skip without one; run them
there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_encode_cases import FHUS, random_chunks, random_merges
from torch_pretok_cases import all_inputs, code_points
from torch_unigram_cases import LATTICES, random_lattice

from shredword_tpu_torch import (BPETrainer, Tokenizer, UnigramTokenizer,
                                 UnigramTrainer)
from shredword_tpu_torch.ops import (_kernels, bpe_giant, bpe_hist,
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


def _calls(kernel, plain, states, merges, steps, **kw):
    """Drive the kernel on states[1] and its plain version on states[0]
    with the same calls of `steps` merges; after every call the records
    and every state tensor must be identical.  Returns the merges done."""
    n_done, done = 0, 0
    while n_done < merges and not done:
        allowed = merges - n_done
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
    return n_done


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
}


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["none", "nccl1"])
@pytest.mark.parametrize("case", sorted(SHARDED_GIANT_CASES))
def test_sharded_giant_kernel_call_by_call(case, reduce, cuda, request):
    """The row-sharded giant step (G1, giant_sharded_train) on one rank's
    whole table against its plain version after every call: all five
    record lanes, tokens, the table and the row bounds; 2 * steps + 1
    launches a call; the reduces over a one-rank NCCL group or none."""
    from shredword_tpu_torch.parallel import giant as par_giant

    corpus_kw, v, steps, merges, minf, unk = SHARDED_GIANT_CASES[case]
    c = bpe_hist.build_layout(*_corpus(**corpus_kw), 64, dtype=np.int32)
    states = []
    for dev in ("cpu", cuda):
        tw = torch.tensor(c.tw, device=dev)
        wc = torch.tensor(c.wcount.reshape(-1), device=dev)
        states.append([tw, wc, *par_giant.init_row_shard(tw, wc, unk, v, 0,
                                                         v)])
    kw = {}
    if reduce == "nccl1":
        dist = request.getfixturevalue("nccl_world1")
        kw = dict(reduce_key=lambda k: dist.all_reduce(
            k, op=dist.ReduceOp.MAX), reduce_deltas=dist.all_reduce)
    kernel = _kernels.giant_sharded_train
    calls = []

    def run(*state, **ckw):
        n0 = kernel.launches
        recs = kernel(*state, base=0, **kw, **ckw)
        calls.append((kernel.launches - n0, ckw["steps"]))
        return recs

    def plain(*state, **ckw):
        return _kernels.giant_sharded_train_plain(*state, base=0, **ckw)

    n = _calls(run, plain, states, merges, steps, unk=unk, min_freq=minf)
    assert all(k == 2 * s + 1 for k, s in calls) and calls
    assert (n == merges) == (minf == 2) and n > 0


# ---------------------------------------------------------------------
# the encoder (csrc/encode.cu)
# ---------------------------------------------------------------------

# name: (v, n_long): the dense table below vocab 4097, the hash table
# above; chunks over 64 bytes take the kernel's global-memory mode
ENCODE_CASES = {"dense_v300": (300, 0), "dense_v768_long": (768, 12),
                "dense_v4096": (4096, 0), "hash_v5000_long": (5000, 12)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_kernel_matches_plain(case, cuda):
    v, n_long = ENCODE_CASES[case]
    merges = random_merges(v, v - 256)
    flat, lens = random_chunks(v + 1, 3000, n_long=n_long)
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
    assert ik.dtype == ip.dtype == torch.int16
    torch.testing.assert_close(ck.cpu(), cp, rtol=0, atol=0)
    torch.testing.assert_close(ik.cpu(), ip, rtol=0, atol=0)
    assert len(ip) < len(flat) * 0.9                   # merges fired
    lookups = torch.zeros(1, dtype=torch.int64, device=cuda)
    encode_ops.encode_core(torch.from_numpy(flat).to(cuda),
                           torch.from_numpy(lens.astype(np.int32)).to(cuda),
                           tables[cuda], v=v, lookups=lookups)
    assert int(lookups) >= int((lens - 1).sum())


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


# ---------------------------------------------------------------------
# the Unigram lattice kernels (csrc/unigram.cu)
# ---------------------------------------------------------------------

def _lattice_on(dev, case):
    table, wlen, wcount, logp = random_lattice(case)
    dt = unigram_ops.make_device_table(table, wlen, wcount, dev)
    return (dt.ids, torch.from_numpy(logp.astype(np.float32)).to(dev),
            dt.wlen, dt.wcount)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LATTICES))
def test_unigram_kernels_match_plain(case, cuda):
    """U1 within rtol=1e-5, atol=1e-6 of its plain version (both sum in
    float64; their float32 posteriors may differ by an ulp of expf) and
    its log-likelihood within 1e-6 relative; U2 identical.  "long_l70"
    runs the kernels' global-scratch mode."""
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
    inputs (cases, fuzz strings, long runs across tiles), three launches
    a call, and the device splitter's starts equal the host splitter's."""
    table = pretok_ops.class_table()
    for s in all_inputs():
        cp = code_points(s)
        cls = torch.from_numpy(table[cp].astype(np.int8))
        padded = torch.cat([cls, torch.full((5,), 16, dtype=torch.int8)])
        n0 = pretok_ops.gpt_starts_mask.launches
        got = pretok_ops.gpt_starts_mask(padded.to(cuda), len(cp))
        assert pretok_ops.gpt_starts_mask.launches - n0 == 3
        want = pretok_ops.gpt_starts_mask_plain(padded, len(cp))
        assert torch.equal(got.cpu(), want), repr(s[:40])
        np.testing.assert_array_equal(
            pretok_ops.gpt_starts_device(cp, device=cuda),
            pretok_ops.gpt_starts(cp))
    empty = torch.full((4,), 16, dtype=torch.int8, device=cuda)
    assert not pretok_ops.gpt_starts_mask(empty, 0).any()
