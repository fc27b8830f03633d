"""The port's Unigram E-step where float32 loses the lattice: words whose
only paths run through pieces pruned to logp -1e30.

There the JAX package's device E-step counts inf and its next M-step
gives NaN log-probs; the port counts an overflowed posterior as 1 (the
word's count) in the kernel and its plain version alike, and gives what
the float64 "cpu" backend gives.  Wherever the JAX package's counts are
finite the two packages agree (expected counts rtol=atol=1e-5 and the
log-likelihood 1e-6 relative, as in tests/test_torch_unigram.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from shredword_tpu.models.unigram import UnigramTrainer as JaxTrainer
from shredword_tpu.ops import unigram_ops as jax_ops
from shredword_tpu_torch import UnigramTokenizer, UnigramTrainer
from shredword_tpu_torch.ops import unigram_ops
from torch_unigram_cases import OVERFLOW_CONFIG as CONFIG
from torch_unigram_cases import OVERFLOW_TEXT as TEXT
from torch_unigram_cases import overflow_lattice


def test_overflow_lattice_matches_jax_where_finite():
    table, wlen, wcount, logp = overflow_lattice()
    n = len(logp)
    dt = unigram_ops.make_device_table(table, wlen, wcount, "cpu")
    lp = torch.from_numpy(logp.astype(np.float32))
    counts, ll = unigram_ops.fb_core_plain(dt.ids, lp, dt.wlen, dt.wcount)
    ids_s = np.transpose(table, (1, 0, 2))
    lp_ext = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    jc, jl = jax_ops._fb_device(jnp.asarray(ids_s), jnp.asarray(lp_ext),
                                jnp.asarray(wlen), jnp.asarray(wcount),
                                n_pieces=n)
    jc = np.asarray(jc)
    fin = np.isfinite(jc)
    assert not fin.all()                # the JAX E-step overflows here
    assert torch.isfinite(counts).all()
    np.testing.assert_allclose(counts.numpy()[fin], jc[fin], rtol=1e-5,
                               atol=1e-5)
    assert abs(float(ll) - float(jl)) <= 1e-6 * abs(float(jl))
    # an overflowed piece counts at most its occurrences' word counts
    occ = np.zeros(n)
    np.add.at(occ, table[table >= 0],
              np.broadcast_to(wcount[:, None, None], table.shape)[
                  table >= 0])
    assert (counts.numpy()[~fin] <= occ[~fin]).all()
    # the wrapper on the CPU, with the table's hot ids, is the plain version
    got = unigram_ops.fb_core(dt.ids, lp, dt.wlen, dt.wcount, dt.hot)
    assert torch.equal(got[0], counts) and torch.equal(got[1], ll)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("nan") / "c.txt"
    path.write_text(TEXT)
    return str(path)


def _train(corpus, **kw):
    t = UnigramTrainer(**CONFIG, **kw)
    t.load_corpus(corpus)
    t.train()
    return t


def test_device_path_gives_a_finite_model_that_encodes(corpus, tmp_path):
    t = _train(corpus, device="cpu")
    assert np.isfinite(t.log_probs).all()
    assert np.isfinite(t.final_ll)
    t.save(str(tmp_path / "u.model"))
    tok = UnigramTokenizer.load(str(tmp_path / "u.model"), device="cpu")
    ids = tok.encode_array(TEXT)
    assert tok.decode(ids) == TEXT.lower()


def test_device_path_equals_cpu_backend(corpus, monkeypatch):
    """The device path (the plain versions) gives the float64 backend's
    pieces; the JAX package's device path gives NaN log-probs here (the
    divergence), and its cpu backend the same pieces as the port."""
    dev = _train(corpus, device="cpu")
    cpu = _train(corpus, backend="cpu")
    assert dev.pieces == cpu.pieces
    np.testing.assert_allclose(dev.log_probs, cpu.log_probs, rtol=1e-4,
                               atol=1e-4)
    assert abs(dev.final_ll - cpu.final_ll) <= 1e-6 * abs(cpu.final_ll)
    jax_cpu = JaxTrainer(**CONFIG, backend="cpu")
    jax_cpu.load_corpus(corpus)
    jax_cpu.train()
    assert jax_cpu.pieces == cpu.pieces
    monkeypatch.setenv("SHRED_INTERPRET_OK", "1")
    jax_dev = JaxTrainer(**CONFIG)
    jax_dev.load_corpus(corpus)
    jax_dev.train()
    assert np.isnan(jax_dev.log_probs).any()
