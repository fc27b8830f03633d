"""The port's BPETrainer (shredword_tpu_torch) against the JAX package's
trainer: byte-identical .model/.vocab files on the golden corpora,
checkpoints that cross from one package to the other, routing, device
handling, and a JAX-free import."""

import contextlib
import logging
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_dist_workers import one_rank_gloo

from golden.corpus_gen import GOLDEN_CONFIGS
from shredword_tpu import checkpoint as ckpt
from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu_torch import BPEConfig, BPETrainer
from shredword_tpu_torch import checkpoint as port_ckpt
from shredword_tpu_torch.errors import (ConfigError, SerializationError,
                                       TrainingError)
from shredword_tpu_torch.ops import _kernels

CONFIGS = [(name, i) for name, cfgs in GOLDEN_CONFIGS.items()
           for i in range(len(cfgs))]


def _save(trainer, tmp_path, tag):
    mp, vp = tmp_path / f"{tag}.model", tmp_path / f"{tag}.vocab"
    trainer.save(str(mp), str(vp))
    return mp.read_bytes(), vp.read_bytes()


def _port(cfg, **kw):
    v, unk, cov, mpf = cfg
    return BPETrainer(v, unk, cov, mpf, backend="cuda", device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_flat_files():
    return {}


@pytest.mark.parametrize("engine", ["hist", "giant", "flat"])
@pytest.mark.parametrize("name,i", CONFIGS)
def test_model_bytes_match_jax_flat(name, i, engine, request, tmp_path,
                                    jax_flat_files):
    cfg = GOLDEN_CONFIGS[name][i]
    path = request.getfixturevalue(f"{name}_corpus_file")
    if (name, i) not in jax_flat_files:
        j = JaxTrainer(*cfg, backend="tpu", engine="flat")
        j.load_corpus(path)
        j.train()
        jax_flat_files[name, i] = _save(j, tmp_path, "jax")
    t = _port(cfg, engine=engine)
    t.load_corpus(path)
    t.train()
    assert _save(t, tmp_path, "port") == jax_flat_files[name, i]


@pytest.fixture
def one_thread():
    """One PyTorch thread: the plain versions' many small ops run many
    times slower when the test workers' thread pools oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["auto", "gloo1"])
def test_config5_bytes_match_jax_flat(route, zipf_corpus_file, tmp_path,
                                      jax_flat_files, one_thread):
    """BASELINE config 5's arguments (unk 0, coverage 1.0, min_pair_freq
    2) on the zipf corpus, which runs out of pairs at 725 merges: auto at
    vocab 65536 (the table engines decline, the flat engine trains) and
    a one-rank gloo group (the row-sharded giant engine, G1's plain
    version; at vocab 4608, as a [65536, 65536] table is 17 GB) save the
    bytes of the JAX package's flat engine at 65536."""
    cfg = (65536, 0, 1.0, 2)
    if "config5" not in jax_flat_files:
        j = JaxTrainer(*cfg, backend="tpu", engine="flat")
        j.load_corpus(zipf_corpus_file)
        assert j.train() == 725
        jax_flat_files["config5"] = _save(j, tmp_path, "jax")
    with contextlib.ExitStack() as stack:
        kw, engine = {}, "flat engine"
        if route == "gloo1":
            cfg, engine = (4608, *cfg[1:]), "sharded giant engine"
            kw["mesh"] = stack.enter_context(
                one_rank_gloo(str(tmp_path / "store")))
        t = _port(cfg, **kw)
        t.load_corpus(zipf_corpus_file)
        n, logs = _train_logged(t)
    assert n == 725 and any(engine in m for m in logs)
    assert _save(t, tmp_path, "port") == jax_flat_files["config5"]


def test_cpu_backend_matches_jax_cpu_backend(small_corpus_file, tmp_path):
    cfg = GOLDEN_CONFIGS["small"][2]
    j = JaxTrainer(*cfg, backend="cpu")
    j.load_corpus(small_corpus_file)
    j.train()
    t = BPETrainer(*cfg, backend="cpu")
    t.load_corpus(small_corpus_file)
    t.train()
    assert _save(t, tmp_path, "port") == _save(j, tmp_path, "jax")


@pytest.mark.parametrize("engine", ["hist", "giant", "flat"])
def test_jax_checkpoint_resumes_in_port(engine, zipf_corpus_file, tmp_path):
    cfg = (600, -1, 0.995, 10)
    full = JaxTrainer(*cfg, backend="tpu", engine="flat")
    full.load_corpus(zipf_corpus_file)
    n = full.train()
    assert n > 40
    half = JaxTrainer(*cfg, backend="tpu", engine="flat")
    half.load_corpus(zipf_corpus_file)
    assert half.train(max_merges=25) == 25
    cp = str(tmp_path / "jax.ckpt")
    half.save_checkpoint(cp)

    auto_cp = str(tmp_path / "port.ckpt")
    t = _port(cfg, engine=engine, checkpoint_path=auto_cp,
              checkpoint_every=8, merges_per_device_call=8)
    t.load_corpus(zipf_corpus_file)
    assert t.load_checkpoint(cp) == 25
    assert t.train() == n - 25
    np.testing.assert_array_equal(t.merges, full.merges)
    np.testing.assert_array_equal(t.merge_freqs, full.merge_freqs)
    np.testing.assert_array_equal(t.token_frequencies(),
                                  full.token_frequencies())
    # the port's own checkpoint carries the replayed prefix
    _, merges, _ = ckpt.load_checkpoint(auto_cp)
    assert len(merges) > 25
    np.testing.assert_array_equal(merges, full.merges[:len(merges)])


@pytest.mark.parametrize("engine", ["hist", "flat", "giant"])
def test_port_checkpoint_resumes_in_jax(engine, zipf_corpus_file, tmp_path):
    """The reverse direction: a checkpoint the port writes (through its
    own checkpoint module) resumes in the JAX package."""
    cfg = (600, -1, 0.995, 10)
    full = _port(cfg, engine=engine)
    full.load_corpus(zipf_corpus_file)
    n = full.train()
    assert n > 40
    half = _port(cfg, engine=engine)
    half.load_corpus(zipf_corpus_file)
    assert half.train(max_merges=25) == 25
    cp = str(tmp_path / "port.ckpt")
    half.save_checkpoint(cp)
    _, merges, _ = port_ckpt.load_checkpoint(cp)
    np.testing.assert_array_equal(merges, full.merges[:25])

    j = JaxTrainer(*cfg, backend="tpu", engine="flat")
    j.load_corpus(zipf_corpus_file)
    assert j.load_checkpoint(cp) == 25
    assert j.train() == n - 25
    np.testing.assert_array_equal(j.merges, full.merges)
    np.testing.assert_array_equal(j.merge_freqs, full.merge_freqs)
    np.testing.assert_array_equal(j.token_frequencies(),
                                  full.token_frequencies())


def test_checkpoint_rejects_garbage(tmp_path):
    """The port's checkpoint module refuses a file whose header is not
    JSON, and one of another format, as the JAX package's does
    (tests/test_checkpoint.py:76)."""
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00not json hereXXXX")
    other = tmp_path / "other.ckpt"
    other.write_bytes(len(b'{"magic": "x"}').to_bytes(8, "little")
                      + b'{"magic": "x"}')
    for path in (bad, other):
        with pytest.raises(SerializationError):
            port_ckpt.load_checkpoint(str(path))
        with pytest.raises(ckpt.SerializationError):
            ckpt.load_checkpoint(str(path))


def test_incremental_train_matches_one_call(small_corpus_file):
    cfg = GOLDEN_CONFIGS["small"][0]
    one = _port(cfg)
    one.load_corpus(small_corpus_file)
    one.train()
    two = _port(cfg)
    two.load_corpus(small_corpus_file)
    assert two.train(max_merges=10) == 10
    two.train()
    np.testing.assert_array_equal(two.merges, one.merges)
    np.testing.assert_array_equal(two.token_frequencies(),
                                  one.token_frequencies())


def test_cuda_backend_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA"):
        BPETrainer(300, -1, backend="cuda")
    BPETrainer(300, -1, backend="cuda", device="cpu")
    BPETrainer(300, -1, backend="cpu")


def test_config_validation():
    with pytest.raises(ConfigError):
        BPEConfig(backend="tpu").validate()
    with pytest.raises(ConfigError):
        BPEConfig(engine="sparse").validate()
    cfg = BPEConfig(target_vocab_size=300, min_pair_freq=0,
                    character_coverage=1.0).validate()
    assert (cfg.min_pair_freq, cfg.character_coverage) == (2000, 0.995)
    assert cfg.target_merges == 44 and cfg.backend == "cuda"


@pytest.mark.parametrize("kw,route", [
    (dict(target_vocab_size=5000), "giant"),
    (dict(target_vocab_size=400, engine="giant"), "giant"),
    (dict(target_vocab_size=400, shards=2), "sharded"),
])
def test_unported_routes_raise(kw, route, tmp_path):
    """The giant routes (auto above vocab 4096, engine="giant" at any
    vocab) train and match the JAX package.  Sharded training runs over
    torch.distributed: without a process group shards=2 is a config
    error that says how to start one (sharded training itself is tested
    in ranks in tests/test_torch_parallel.py)."""
    data = b"the quick brown fox jumps over the lazy dog\n" * 20
    t = BPETrainer(unk_id=-1, min_pair_freq=2, device="cpu", **kw)
    t.load_corpus_bytes(data)
    if route == "sharded":
        with pytest.raises(ConfigError, match="torch.distributed"):
            t.train()
        return
    j = JaxTrainer(kw["target_vocab_size"], -1, min_pair_freq=2,
                   backend="tpu", engine="flat")
    j.load_corpus_bytes(data)
    assert t.train() == j.train() > 0
    assert _save(t, tmp_path, "port") == _save(j, tmp_path, "jax")


def _train_logged(trainer):
    """(trainer.train(), the messages it logged at info level)."""
    logged = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger("shredword_tpu_torch")
    logger.addHandler(handler)
    try:
        return trainer.train(), logged
    finally:
        logger.removeHandler(handler)


def test_auto_falls_back_to_flat_for_long_words(tmp_path):
    data = (b"x" * 100 + b" the quick brown fox\n") * 20
    auto = BPETrainer(300, -1, 0.9999, 2, device="cpu")
    auto.load_corpus_bytes(data)
    n, logged = _train_logged(auto)
    assert any("using the flat engine" in m for m in logged)
    flat = BPETrainer(300, -1, 0.9999, 2, device="cpu", engine="flat")
    flat.load_corpus_bytes(data)
    assert flat.train() == n > 0
    assert _save(auto, tmp_path, "a") == _save(flat, tmp_path, "f")
    hist = BPETrainer(300, -1, 0.9999, 2, device="cpu", engine="hist")
    hist.load_corpus_bytes(data)
    with pytest.raises(TrainingError, match="longer"):
        hist.train()


def test_launch_counter_stays_zero_on_cpu(small_corpus_file):
    counters = (_kernels.hist_fused_train, _kernels.giant_train_step)
    for engine in ("hist", "giant"):
        t = _port(GOLDEN_CONFIGS["small"][0], engine=engine)
        t.load_corpus(small_corpus_file)
        assert t.train() > 0
    assert [k.launches for k in counters] == [0, 0]


def test_giant_decline_falls_to_flat(tmp_path):
    """Above vocab 4096 a word longer than the layout takes makes the
    giant engine decline: auto trains on the flat engine (and says so),
    engine "hist" and "giant" raise."""
    data = (b"x" * 100 + b" the quick brown fox\n") * 20
    auto = BPETrainer(5000, -1, 0.9999, 2, device="cpu")
    auto.load_corpus_bytes(data)
    n, logged = _train_logged(auto)
    assert any("using the flat engine" in m for m in logged)
    flat = BPETrainer(5000, -1, 0.9999, 2, device="cpu", engine="flat")
    flat.load_corpus_bytes(data)
    assert flat.train() == n > 0
    assert _save(auto, tmp_path, "a") == _save(flat, tmp_path, "f")
    for engine, match in (("hist", "fit"), ("giant", "envelope")):
        t = BPETrainer(5000, -1, 0.9999, 2, device="cpu", engine=engine)
        t.load_corpus_bytes(data)
        with pytest.raises(TrainingError, match=match):
            t.train()


def test_import_and_train_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith("jax."):
                    raise ImportError("jax is blocked")

        sys.meta_path.insert(0, BlockJax())
        from shredword_tpu_torch import BPETrainer
        t = BPETrainer(300, -1, 0.995, 2, device="cpu")
        t.load_corpus_bytes(b"hello world, hello there\\n" * 30)
        t.train()
        t.save({str(tmp_path / 'm.model')!r}, {str(tmp_path / 'm.vocab')!r})
        assert not [m for m in sys.modules if m.split(".")[0] == "jax"]
        print("merges", t.num_merges)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "merges" in r.stdout and (tmp_path / "m.vocab").exists()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")


def _entry_calls():
    from shredword_tpu_torch.ops import bpe_giant, bpe_hist, bpe_ops
    from shredword_tpu_torch.parallel import hist as par_hist

    tokens = np.array([97, 98, 97, 98], np.int32)
    word_id = np.array([0, 0, 1, 1], np.int32)
    wc = np.ones(2, np.int32)
    kw = dict(target_merges=4, min_pair_freq=1)
    c = bpe_hist.build_layout(tokens, word_id, wc, 64)
    table = np.zeros((384, 384), np.int32)
    return {
        "hist_train": lambda: bpe_hist.hist_train(tokens, word_id, wc, **kw),
        "giant_train": lambda: bpe_giant.giant_train(tokens, word_id, wc,
                                                     **kw),
        "sharded_hist_train": lambda: par_hist.sharded_hist_train(
            tokens, word_id, wc, mesh=None, **kw),
        "fused_hist_train": lambda: bpe_hist.fused_hist_train(
            c, 384, target_merges=4, unk_id=-1, min_pair_freq=1,
            steps_per_call=4),
        "hist_train_init": lambda: bpe_hist.hist_train_init(c, -1, 4, 384),
        "make_state": lambda: bpe_ops.make_state(tokens, word_id, wc),
        "state_from_jax": lambda: bpe_hist.state_from_jax(c.tw, c.wcount,
                                                          table),
        "giant_state_from_jax": lambda: bpe_giant.giant_state_from_jax(
            c.tw, c.wcount, table.reshape(384, 3, 128),
            np.zeros((384, 1), np.int8), np.zeros((3, 128), np.int32)),
        "shard_state_from_jax": lambda: par_hist.shard_state_from_jax(
            c.tw, c.wcount, table, 0, 1),
    }


@pytest.mark.parametrize("entry", sorted(_entry_calls()))
def test_entry_point_defaults_to_the_card(entry):
    """Called without ``device``, every op entry point runs on the card:
    on a host without one it raises ConfigError instead of running on
    the CPU."""
    _no_card()
    with pytest.raises(ConfigError, match="device='cpu'"):
        _entry_calls()[entry]()


def test_resolve_device_passes_the_cpu_through():
    from shredword_tpu_torch.config import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    _no_card()
    with pytest.raises(ConfigError, match="CUDA"):
        resolve_device("cuda:0")
