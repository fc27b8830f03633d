"""Sharded hist training of the port over torch.distributed, in two gloo
CPU ranks (tests/torch_dist_workers.py), against the JAX package's
sharded engine on a 2-device mesh (interpret mode) and against the
port's single-device training.  Counts are integers, so merges,
frequencies and saved bytes must be identical."""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import jax
import jax.numpy as jnp
import torch_dist_workers as workers
from shredword_tpu import parallel as jax_parallel
from shredword_tpu.ops import bpe_hist as jax_hist
from shredword_tpu.parallel import hist as jax_par_hist
from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu_torch import BPETrainer
from shredword_tpu_torch.ops import _kernels, bpe_hist
from shredword_tpu_torch.parallel import hist


def _rand_arrays(seed=3, n_words=700, alpha=6, max_len=12):
    """Flat tokens, word ids and per-word counts; 'aaaa' runs too."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    lens[:8] = max_len
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < 8] = 97
    return tokens, word_id, rng.randint(1, 60, n_words).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(zipf_corpus_file, tmp_path_factory):
    """Both ranks' results of workers.scenarios (one start-up)."""
    tmp = tmp_path_factory.mktemp("ranks")
    return workers.run_ranks(workers.scenarios, 2, str(tmp),
                             zipf_corpus_file, _rand_arrays(), str(tmp),
                             timeout=150)


@pytest.fixture(scope="module")
def single(zipf_corpus_file, tmp_path_factory):
    """Single-device port training of the ranks' configuration."""
    t = workers._trainer(zipf_corpus_file)
    t.train()
    tmp = tmp_path_factory.mktemp("single")
    t.save(str(tmp / "m"), str(tmp / "v"))
    return (t.merges, t.merge_freqs, t.token_frequencies(),
            (tmp / "m").read_bytes(), (tmp / "v").read_bytes())


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_layout_matches_jax(n_shards):
    """The layout, and each rank's column block, as the JAX package
    builds and places them on a `data` mesh."""
    tokens, word_id, wc = _rand_arrays(n_words=900)
    want = jax_par_hist.shard_layout(tokens, word_id, wc, n_shards)
    got = hist.shard_layout(tokens, word_id, wc, n_shards)
    np.testing.assert_array_equal(got.tw, np.asarray(want.tw))
    np.testing.assert_array_equal(got.wcount, np.asarray(want.wcount))
    assert got.tw.shape[1] % (n_shards * bpe_hist.CHUNK) == 0
    mesh = jax_parallel.make_mesh(n_shards)
    placed = jax.device_put(want.tw, NamedSharding(mesh, P(None, "data")))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    hist_t = np.zeros((384, 384), np.int32)
    for r, dev in enumerate(mesh.devices.flat):
        np.testing.assert_array_equal(
            hist.local_shard(got, r, n_shards).tw, by_device[dev])
        tw_r, wc_r, _ = hist.shard_state_from_jax(want.tw, want.wcount,
                                                  hist_t, r, n_shards,
                                                  device="cpu")
        np.testing.assert_array_equal(tw_r.numpy(), by_device[dev])
    shards = [hist.shard_state_from_jax(want.tw, want.wcount, hist_t, r,
                                        n_shards, device="cpu")[:2]
              for r in range(n_shards)]
    back = hist.shard_state_to_jax(shards, torch.tensor(hist_t))
    np.testing.assert_array_equal(back[0], np.asarray(want.tw))
    np.testing.assert_array_equal(back[1], np.asarray(want.wcount))


def test_sharded_engine_matches_jax_and_single_device(ranks):
    """sharded_hist_train in 2 gloo ranks == JAX sharded_hist_train on a
    2-device mesh == the port's single-device engine; a resumed run
    continues the same sequence."""
    tokens, word_id, wc = _rand_arrays()
    kw = dict(target_merges=40, unk_id=-1, min_pair_freq=2)
    jm, jf = jax_parallel.sharded_hist_train(
        tokens, word_id, wc, mesh=jax_parallel.make_mesh(2),
        interpret=True, max_steps_per_call=16, **kw)
    sm, sf, _, _ = bpe_hist.hist_train(tokens, word_id, wc, device="cpu",
                                       **kw)
    np.testing.assert_array_equal(sm, jm)
    np.testing.assert_array_equal(sf, jf)
    assert len(jm) == 40
    for r in ranks:
        m, f = r["engine"]
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(f, jf)
        m2, f2 = r["engine_resumed"]
        np.testing.assert_array_equal(np.concatenate([jm[:9], m2]), jm)
        np.testing.assert_array_equal(np.concatenate([jf[:9], f2]), jf)


@pytest.mark.parametrize("case", sorted(workers.CHAIN_CASES))
def test_sharded_wrapper_matches_jax_mesh_and_single_device(ranks, case):
    """hist_sharded_train in 2 gloo ranks (each on its column block, the
    deltas all-reduced), call by call, against the JAX sharded loop on a
    2-device mesh (interpret mode) and the single-device loop on the
    whole layout: records, the table and the concatenated tokens after
    every call."""
    minf, steps, target = workers.CHAIN_CASES[case]
    tokens, word_id, wc = _rand_arrays()
    c = jax_par_hist.shard_layout(tokens, word_id, wc, 2)
    L, W = c.tw.shape
    v = -(-(256 + target) // 128) * 128
    jloop = jax_par_hist.build_sharded_hist_loop(
        jax_parallel.make_mesh(2), v, L, W, target_merges=target,
        max_steps=steps, interpret=True)
    jwc = jnp.asarray(c.wcount)
    js = [jnp.asarray(c.tw).astype(jnp.int16),
          jax_hist.init_hist(c, jnp.int32(-1), v=v),
          jnp.zeros((target, 2), jnp.int32), jnp.zeros(target, jnp.int32),
          jnp.int32(0), jnp.bool_(False)]
    tw1, wc1, _ = bpe_hist.state_from_jax(c.tw, c.wcount, np.zeros(1),
                                          device="cpu")
    h1 = bpe_hist.init_hist(tw1, wc1, -1, v)
    calls = [r["chain"][case] for r in ranks]
    assert len(calls[0]) == len(calls[1]) >= 2
    n = 0
    for (recs, tw_0, table), (recs_1, tw_1, table_1) in zip(*calls):
        js = list(jloop(js[0], jwc, *js[1:], jnp.int32(-1), jnp.int32(minf)))
        one = _kernels.hist_sharded_train(
            tw1, wc1, h1, unk=-1, min_freq=minf, n_done=n, init_done=0,
            allowed=target - n, steps=len(recs)).numpy()
        np.testing.assert_array_equal(recs, one)
        np.testing.assert_array_equal(recs_1, one)
        did = recs[:, 3] != 0
        n_j = int(js[4])
        np.testing.assert_array_equal(recs[did, :2], np.asarray(js[2])[n:n_j])
        np.testing.assert_array_equal(recs[did, 2], np.asarray(js[3])[n:n_j])
        for t in (table, table_1, h1.numpy()):
            np.testing.assert_array_equal(t, np.asarray(js[1]))
        tw = np.concatenate([tw_0, tw_1], axis=1)
        np.testing.assert_array_equal(tw, np.asarray(js[0]))
        np.testing.assert_array_equal(tw, tw1.numpy())
        n = n_j
    assert bool(js[5]) == (case == "min_freq_stop")
    assert n == (24 if case == "min_freq_stop" else target)


@pytest.mark.parametrize("route", ["shards", "mesh"])
def test_bpetrainer_sharded_matches_single_device(ranks, single, route):
    """BPETrainer(shards=2) and BPETrainer(mesh=DeviceMesh) give the
    single-device .model/.vocab bytes and token frequencies on every
    rank, mirroring tests/test_parallel.py::test_bpetrainer_mesh_wiring."""
    for r in ranks:
        merges, freqs, tf, model, vocab = r[route]
        assert len(merges) > 0
        np.testing.assert_array_equal(merges, single[0])
        np.testing.assert_array_equal(freqs, single[1])
        np.testing.assert_array_equal(tf, single[2])
        assert (model, vocab) == single[3:]


def test_sharded_matches_jax_trainer(single, zipf_corpus_file):
    j = JaxTrainer(target_vocab_size=330, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="tpu", engine="flat")
    j.load_corpus(zipf_corpus_file)
    j.train()
    np.testing.assert_array_equal(single[0], j.merges)
    np.testing.assert_array_equal(single[2], j.token_frequencies())


def test_sharded_resume_matches_uninterrupted(ranks, single):
    """Interrupted-then-resumed sharded training equals the
    uninterrupted run, and a single-device checkpoint resumes sharded,
    mirroring tests/test_sharded_resume.py."""
    for r in ranks:
        assert r["half"] == 12
        for key in ("resumed", "single_resumed"):
            merges, freqs, tf, model, vocab = r[key]
            np.testing.assert_array_equal(merges, single[0])
            np.testing.assert_array_equal(freqs, single[1])
            np.testing.assert_array_equal(tf, single[2])
            assert (model, vocab) == single[3:]


def test_shards_must_match_world_size(ranks):
    """shards=N must match the world size: ConfigError says so.  (Above
    vocab 4096 and for words over 64 tokens sharded training routes to
    the giant and flat engines: tests/test_torch_sharded_giant.py and
    tests/test_torch_sharded_flat.py.)"""
    for r in ranks:
        assert "torch.distributed" in r["world"] and "3" in r["world"]


def test_host_shard_splits_work_by_rank(ranks):
    assert [r["host_shard"] for r in ranks] == [slice(0, 3), slice(3, 5)]


def test_shards_without_process_group_raise():
    from shredword_tpu_torch.errors import ConfigError

    t = BPETrainer(330, -1, 0.9995, 5, device="cpu", shards=2)
    t.load_corpus_bytes(b"hello world hello there\n" * 20)
    with pytest.raises(ConfigError, match="torchrun"):
        t.train()


def test_multihost_defaults_to_nccl():
    """initialize() picks no CPU backend on its own: NCCL without a card
    raises and names gloo."""
    from shredword_tpu_torch.errors import ConfigError
    from shredword_tpu_torch.parallel import multihost

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: NCCL is available")
    with pytest.raises(ConfigError, match="gloo"):
        multihost.initialize("tcp://localhost:1", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


def test_global_mesh_on_cpu_under_gloo(tmp_path):
    """global_mesh("cpu") over a one-rank gloo world initialized with an
    explicit backend; the sharded engines take its group."""
    import torch.distributed as dist

    from shredword_tpu_torch.parallel import mesh as par_mesh
    from shredword_tpu_torch.parallel import multihost

    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    multihost.initialize(f"file://{tmp_path / 'store'}", world_size=1,
                         rank=0, backend="gloo")
    try:
        m = multihost.global_mesh("cpu")
        assert m.device_type == "cpu" and m.size() == 1
        assert par_mesh.process_group(m).size() == 1
        tokens, word_id, wc = _rand_arrays(n_words=200)
        got = hist.sharded_hist_train(tokens, word_id, wc, mesh=m,
                                      target_merges=20, unk_id=-1,
                                      min_pair_freq=2, device="cpu")
        want = bpe_hist.hist_train(tokens, word_id, wc, target_merges=20,
                                   unk_id=-1, min_pair_freq=2, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    finally:
        dist.destroy_process_group()
