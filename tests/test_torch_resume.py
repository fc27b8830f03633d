"""Checkpoint and resume through the port's BPETrainer on the hist,
giant and flat engines (their kernels' plain versions here): every
checkpoint written mid-run is a prefix of the uninterrupted run, and a
fresh trainer of either package resumed from it gives the uninterrupted
run's .model/.vocab bytes and token frequencies, exactly.  Then the same
across sharding, in one gloo rank: a single-device checkpoint resumed by
each sharded engine, and a sharded run's checkpoint resumed on one
device.  The card runs these in tests/test_torch_cuda.py -k resume."""

import logging

import pytest
from torch_dist_workers import one_rank_gloo
from torch_resume_cases import (CFG, MERGES, SHARDED, WRITTEN, checkpointed,
                                is_prefix, outputs, resumed, trainer)

from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu_torch.bench import make_long_corpus


@pytest.fixture(scope="module")
def long_corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("long") / "long.txt"
    make_long_corpus(str(path), raw_mb=0.05)
    return str(path)


@pytest.fixture(scope="module")
def corpora(zipf_corpus_file, long_corpus_file):
    return {"zipf": zipf_corpus_file, "long": long_corpus_file}


@pytest.fixture(scope="module")
def runs(zipf_corpus_file, tmp_path_factory):
    """Per engine, made once: the uninterrupted run's outputs and the
    checkpoints a checkpointed run wrote ({merges held: path})."""
    made = {}

    def get(engine):
        if engine not in made:
            d = str(tmp_path_factory.mktemp(f"runs_{engine}"))
            full = trainer(CFG, zipf_corpus_file, engine)
            assert full.train() == MERGES
            want = outputs(full, d, "full")
            t, n, files = checkpointed(CFG, zipf_corpus_file, d, engine)
            assert n == MERGES
            assert outputs(t, d, "checkpointed") == want
            assert [m for m, _ in files] == list(WRITTEN[engine])
            made[engine] = want, dict(files)
        return made[engine]

    return get


@pytest.mark.parametrize("engine,n", [(e, n) for e, ns in WRITTEN.items()
                                      for n in ns])
def test_mid_run_checkpoint_resumes(engine, n, runs, zipf_corpus_file,
                                    tmp_path):
    """The checkpoint a run wrote after n merges (checkpoint_every 100,
    which divides neither the 344 merges nor the flat engine's calls of
    64) holds the uninterrupted run's first n merges and frequencies; a
    fresh port trainer on the same engine and the JAX package's trainer
    (engine "flat"), each resumed from it, save the uninterrupted bytes
    and count the same token frequencies.  Tolerance: exact."""
    want, files = runs(engine)
    ck = files[n]
    assert is_prefix(ck, want[0], want[1])
    t, n0, added = resumed(CFG, zipf_corpus_file, ck, engine)
    assert (n0, added) == (n, MERGES - n)
    assert outputs(t, str(tmp_path), "port") == want

    j = JaxTrainer(*CFG, backend="tpu", engine="flat")
    j.load_corpus(zipf_corpus_file)
    assert j.load_checkpoint(ck) == n
    assert j.train() == MERGES - n
    assert outputs(j, str(tmp_path), "jax") == want


def _logged_train(t, **kw):
    """(t.train(**kw), the messages it logged at info level)."""
    logged = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger("shredword_tpu_torch")
    logger.addHandler(handler)
    try:
        return t.train(**kw), logged
    finally:
        logger.removeHandler(handler)


@pytest.mark.parametrize("direction", ["to_sharded", "to_single"])
@pytest.mark.parametrize("engine", sorted(SHARDED))
def test_resume_across_sharding(engine, direction, corpora, tmp_path):
    """In one gloo rank: a checkpoint that a single-device run wrote
    mid-run (checkpoint_every 50) resumed by BPETrainer(mesh=...), which
    takes the sharded hist engine at vocab 600, the row-sharded giant
    engine at 4608 and the sharded flat engine on words over 64 tokens;
    and the reverse, a sharded train(max_merges=150) saved with
    save_checkpoint and resumed on one device.  Either way the bytes and
    token frequencies of the uninterrupted single-device run.  Sharded
    training writes no checkpoint of its own mid-run, in either package:
    it resumes through load_checkpoint.  Tolerance: exact."""
    cfg, corpus = SHARDED[engine]
    path, d = corpora[corpus], str(tmp_path)
    full = trainer(cfg, path)
    total = full.train()
    want = outputs(full, d, "full")
    with one_rank_gloo(str(tmp_path / "store")) as group:
        if direction == "to_sharded":
            # the first file: 50 merges (64 on the flat engine's calls),
            # where the replayed long words still reach past 64 tokens
            _, _, files = checkpointed(cfg, path, d, every=50)
            n, ck = files[0]
            assert 0 < n < total and is_prefix(ck, want[0], want[1])
            t = trainer(cfg, path, mesh=group)
            assert t.load_checkpoint(ck) == n
            added, logged = _logged_train(t)
        else:
            n = 150
            half = trainer(cfg, path, mesh=group,
                           checkpoint_path=str(tmp_path / "unused.ckpt"),
                           checkpoint_every=40)
            got, logged = _logged_train(half, max_merges=n)
            assert got == n
            assert not (tmp_path / "unused.ckpt").exists()
            ck = str(tmp_path / "sharded.ckpt")
            half.save_checkpoint(ck)
            assert is_prefix(ck, want[0], want[1])
    # train(max_merges=150) sizes the table for 256 + 150 ids, so the
    # sharded route takes the hist engine there at vocab 4608 too, as the
    # JAX package's does; the resumed run takes the giant engine
    took = "hist" if (engine, direction) == ("giant", "to_single") else engine
    assert any(f"sharded {took} engine" in m for m in logged)
    if direction == "to_single":
        t, n0, added = resumed(cfg, path, ck)
        assert n0 == n
    assert added == total - n
    assert outputs(t, d, "resumed") == want
