"""G1's per-rank chunked layout and its plain version on the CPU
(shredword_tpu_torch/parallel/giant.rank_layout,
ops/_kernels.giant_sharded_train_plain).

Each rank lays its column block out as the giant engine lays out a
corpus: words sorted by length into chunks with an exact presence index,
and a merge reads only the chunks that hold both ids.  Held here against
the unchunked block of parallel/hist.local_shard (the JAX package's
P(None, "data") block) and the unchunked pass over it, and a rank alone
against the JAX package's sharded_giant_train on a one-device mesh.
Counts are integers, so everything must be identical."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_dist_workers import one_rank_gloo

from shredword_tpu.parallel import make_mesh
from shredword_tpu.parallel import sharded_giant_train as jax_sharded_giant
from shredword_tpu_torch.ops import _kernels, bpe_hist
from shredword_tpu_torch.parallel import giant as par_giant
from shredword_tpu_torch.parallel import hist as par_hist

PAD = _kernels.PAD
CW = 256          # chunk width: several chunks on a small corpus


def _corpus(seed, n_words=1500, alpha=6, max_len=12, unk=None,
            equal_weights=False):
    """(tokens, word_id, per-word counts): random words over `alpha`
    letters, the first 10 'aaaa...' runs."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    lens[:10] = max_len
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < 10] = 97
    if unk is not None:
        tokens[rng.rand(len(tokens)) < 0.05] = unk
    wc_word = rng.randint(1, 60, n_words).astype(np.int32)
    if equal_weights:
        wc_word[:] = 1
    return tokens, word_id, wc_word


def _presence(tw: np.ndarray, v: int, cw: int) -> np.ndarray:
    """A fresh count of presT int8 [v, NC] from tw [L, NC * cw]."""
    nc = tw.shape[1] // cw
    pres = np.zeros((v, nc), np.int8)
    for c in range(nc):
        ids = np.unique(tw[:, c * cw:(c + 1) * cw])
        pres[ids[ids >= 0], c] = 1
    return pres


def _unpermute(tw: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """The block of a rank_layout tw, columns in the block's order."""
    block = np.empty((tw.shape[0], len(perm)), tw.dtype)
    block[:, perm] = tw[:, :len(perm)]
    return block


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_rank_layout_is_a_permutation_of_the_block(n_shards):
    """Each rank's chunked layout, un-permuted by its perm, is
    local_shard's block; the rest is padding; words are sorted by
    length, each chunk's longest word and the presence index are exact."""
    v = 1024
    c = par_hist.shard_layout(*_corpus(70, n_words=2500, max_len=20),
                              n_shards, dtype=np.int32)
    n_words = 0
    for rank in range(n_shards):
        own = par_hist.local_shard(c, rank, n_shards)
        lay = par_giant.rank_layout(own, v, cw=CW)
        L, ws = own.tw.shape
        nc = lay.presT.shape[1]
        assert lay.tw.dtype == np.int32 and lay.tw.shape == (L, nc * CW)
        assert nc == -(-ws // CW) and sorted(lay.perm) == list(range(ws))
        np.testing.assert_array_equal(_unpermute(lay.tw, lay.perm), own.tw)
        wc = np.empty(ws, np.int32)
        wc[lay.perm] = lay.wc[0, :ws]
        np.testing.assert_array_equal(wc, own.wcount.reshape(-1))
        assert (lay.tw[:, ws:] == PAD).all() and (lay.wc[0, ws:] == 0).all()
        lens = (lay.tw >= 0).sum(0)
        words = lens[:lay.n_words]
        assert (words > 0).all() and (np.diff(words) >= 0).all()
        assert (lens[lay.n_words:] == 0).all()
        np.testing.assert_array_equal(lay.lens, lens.reshape(nc, CW).max(1))
        np.testing.assert_array_equal(lay.presT, _presence(lay.tw, v, CW))
        n_words += lay.n_words
    assert n_words == 2500


# name: (corpus arguments, v, steps per call, merges, min_pair_freq, unk)
PLAIN_CASES = {
    "ties_v384": (dict(seed=60, alpha=4, equal_weights=True), 384, 7, 100,
                  2, -1),
    "runs_v512_L32": (dict(seed=61, max_len=30, alpha=2), 512, 32, 200, 2,
                      -1),
    "unk_v640": (dict(seed=62, alpha=12, unk=98), 640, 64, 300, 2, 98),
    "min_freq_stop_v512": (dict(seed=63), 512, 32, 250, 300, -1),
}


def _unchunked_calls(tw, wc, hist, bounds, *, unk, min_freq, n_done,
                     init_done, allowed, steps):
    """G1's plain version with the corpus pass over every column of the
    unchunked block (merge_pass_plain), as it was before the chunked
    layout: the reference the chunked pass must equal."""
    v = hist.shape[1]
    records = torch.zeros((steps, 5), dtype=torch.int32)
    for i in range(steps):
        m, a, n_refresh = _kernels._lazy_pick(hist, bounds, min_freq)
        if not (m > 0 and not init_done and i < allowed):
            records[i:, 2] = m
            records[i, 4] = n_refresh
            break
        b = int((hist[a] == m).nonzero()[0, 0])
        new = 256 + n_done + i
        records[i] = torch.tensor([a, b, m, 1, n_refresh])
        dl, dr, _ = _kernels.merge_pass_plain(tw, wc, a, b, new, unk, v)
        _kernels.apply_row_shard(hist, bounds, 0, a, b, new, dl, dr)
    return records


_runs: dict = {}


def _run(case):
    """One rank alone on the case's corpus, call by call: the chunked
    plain version and the unchunked reference.  Returns (layout, the
    chunked state, the reference's state, both records, merges)."""
    if case in _runs:
        return _runs[case]
    corpus_kw, v, steps, merges, minf, unk = PLAIN_CASES[case]
    c = par_hist.shard_layout(*_corpus(**corpus_kw), 1, dtype=np.int32)
    own = par_hist.local_shard(c, 0, 1)
    lay = par_giant.rank_layout(own, v, cw=CW)
    tw = torch.from_numpy(lay.tw.copy())
    wc = torch.from_numpy(lay.wc.reshape(-1).copy())
    chunked = [tw, wc, *par_giant.init_row_shard(tw, wc, unk, v, 0, v),
               torch.from_numpy(lay.presT.copy())]
    rtw = torch.from_numpy(own.tw.copy())
    rwc = torch.from_numpy(own.wcount.reshape(-1).copy())
    ref = [rtw, rwc, *par_giant.init_row_shard(rtw, rwc, unk, v, 0, v)]
    nc_used = max(1, -(-lay.n_words // CW))
    recs, ref_recs = [], []
    n_done, done = 0, 0
    while n_done < merges and not done:
        allowed = merges - n_done
        ckw = dict(unk=unk, min_freq=minf, n_done=n_done, init_done=done,
                   allowed=allowed, steps=min(steps, allowed))
        recs.append(_kernels.giant_sharded_train(*chunked, base=0,
                                                 nc_used=nc_used, **ckw))
        ref_recs.append(_unchunked_calls(*ref, **ckw))
        n_new = int(recs[-1][:, 3].sum())
        done = int(n_new < ckw["steps"])
        n_done += n_new
    _runs[case] = (lay, chunked, ref, torch.cat(recs), torch.cat(ref_recs),
                   n_done)
    return _runs[case]


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_chunked_plain_equals_unchunked_pass(case):
    """After every merge of the calls, the chunked plain version's
    records, table and bounds equal the unchunked pass's, and its corpus
    un-permuted equals the unchunked block."""
    lay, chunked, ref, recs, ref_recs, n = _run(case)
    minf = PLAIN_CASES[case][4]
    assert (n == PLAIN_CASES[case][3]) == (minf == 2) and n > 0
    assert torch.equal(recs, ref_recs)
    assert torch.equal(chunked[2], ref[2]) and torch.equal(chunked[3], ref[3])
    np.testing.assert_array_equal(
        _unpermute(chunked[0].numpy(), lay.perm), ref[0].numpy())
    assert (chunked[0][:, len(lay.perm):] == PAD).all()


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_maintained_presence_is_exact(case):
    """The presence the plain version maintains (a, b and new in the
    chunks that matched) equals a fresh count over the merged corpus,
    which the merges changed."""
    lay, chunked, _, recs, _, _ = _run(case)
    v = chunked[2].shape[1]
    pres = chunked[4].numpy()
    np.testing.assert_array_equal(pres, _presence(chunked[0].numpy(), v, CW))
    did = recs[:, 3] == 1
    new = 256 + np.flatnonzero(did.numpy())
    assert pres[new].any() and not np.array_equal(pres, lay.presT)


@pytest.fixture
def gloo_world1(tmp_path):
    """A one-rank gloo process group in this process."""
    with one_rank_gloo(str(tmp_path / "store")) as group:
        yield group


def test_world1_passes_no_reduce_and_matches_jax(gloo_world1, monkeypatch):
    """A rank alone (a one-rank gloo group): sharded_giant_train hands G1
    no reduce, makes no collective at all, and its merges and
    frequencies equal the JAX package's sharded_giant_train on a
    one-device mesh."""
    arrays = _corpus(64, n_words=800, alpha=5)
    collectives = []
    for name in ("all_reduce", "all_gather", "broadcast"):
        fn = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _fn=fn, _name=name, **k:
                            collectives.append(_name) or _fn(*a, **k))
    calls = []
    g1 = _kernels.giant_sharded_train

    def spy(*a, **k):
        calls.append((k.get("reduce_key"), k.get("reduce_deltas")))
        return g1(*a, **k)

    monkeypatch.setattr(_kernels, "giant_sharded_train", spy)
    kw = dict(target_merges=160, min_pair_freq=2, max_steps_per_call=48)
    m, f = par_giant.sharded_giant_train(*arrays, mesh=gloo_world1,
                                         device="cpu", **kw)
    jm, jf = jax_sharded_giant(*arrays, mesh=make_mesh(1), **kw)
    assert collectives == [] and len(calls) == 4
    assert all(r == (None, None) for r in calls)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(f, jf)
    assert len(jm) == 160
    hm, hf, _ = bpe_hist.hist_train(*arrays, target_merges=160,
                                    min_pair_freq=2, lazy_final=True,
                                    device="cpu")
    np.testing.assert_array_equal(m, hm)
    np.testing.assert_array_equal(f, hf)
