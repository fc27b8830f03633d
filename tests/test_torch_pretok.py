"""The port's GPT splitter (shredword_tpu_torch/ops/pretok_ops.py)
against the JAX package's, exactly, on tests/test_pretok_dfa.py's cases,
seeded fuzz strings over its alphabet and seeded long texts with runs
over 1024 around the powers of two: the host splitter (gpt_starts,
gpt_split_str, gpt_chunk_lens_bytes), the device splitter's mask
(gpt_starts_mask_plain == the jitted gpt_starts_mask_jnp on a padded
class array, bit for bit) and gpt_starts_device(device="cpu") == the
JAX gpt_starts_device == the regex module's match starts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex as _re
import torch
from torch_pretok_cases import (CASES, LONG_NS, LONG_SEEDS, RUNS_TEXT,
                                code_points, fuzz, long_text)

from shredword_tpu import pretokenize as jax_pretokenize
from shredword_tpu.ops import pretok_ops as J
from shredword_tpu_torch import pretokenize
from shredword_tpu_torch.errors import ConfigError
from shredword_tpu_torch.ops import pretok_ops as P

PAT = _re.compile(pretokenize.PATTERN_GPT)
_MASK_JNP = jax.jit(J.gpt_starts_mask_jnp)
FUZZ = fuzz()
FUZZ_GROUPS = 12


def _padded(cls: np.ndarray) -> np.ndarray:
    """cls padded with class 16 to the JAX splitter's bucket (a power of
    two, at least 1024)."""
    cap = 1024
    while cap < len(cls):
        cap *= 2
    pad = np.full(cap, 16, np.int8)
    pad[:len(cls)] = cls
    return pad


def _check(s: str) -> None:
    assert pretokenize.PATTERN_GPT == jax_pretokenize.PATTERN_GPT
    cp = code_points(s)
    n = len(cp)
    want = J.gpt_starts(cp)
    np.testing.assert_array_equal(P.gpt_starts(cp), want)
    np.testing.assert_array_equal(
        want, [m.start() for m in PAT.finditer(s)])
    cls = P.class_table()[cp].astype(np.int8)
    np.testing.assert_array_equal(cls, J.class_table()[cp].astype(np.int8))
    pad = _padded(cls)
    jmask = np.asarray(_MASK_JNP(jnp.asarray(pad), jnp.int32(n)))
    np.testing.assert_array_equal(
        P.gpt_starts_mask_plain(torch.from_numpy(pad), n).numpy(), jmask)
    np.testing.assert_array_equal(
        P.gpt_starts_mask_plain(torch.from_numpy(cls), n).numpy(),
        jmask[:n])
    got = P.gpt_starts_device(cp, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, J.gpt_starts_device(cp))
    np.testing.assert_array_equal(got, want)
    assert P.gpt_split_str(s) == J.gpt_split_str(s) == PAT.findall(s)
    data = s.encode()
    lens = P.gpt_chunk_lens_bytes(data)
    np.testing.assert_array_equal(lens, J.gpt_chunk_lens_bytes(data))
    np.testing.assert_array_equal(
        np.cumsum(lens) - lens, pretokenize.gpt_starts_bytes(data))


@pytest.mark.parametrize("s", CASES)
def test_case_matches_jax(s):
    _check(s)


@pytest.mark.parametrize("group", range(FUZZ_GROUPS))
def test_fuzz_matches_jax(group):
    for s in FUZZ[group::FUZZ_GROUPS]:
        _check(s)


@pytest.mark.parametrize("seed", LONG_SEEDS)
@pytest.mark.parametrize("n", LONG_NS)
def test_long_runs_match_jax(n, seed):
    s = long_text(n, seed)
    assert len(s) == n
    _check(s)


@pytest.mark.parametrize("n", [len(RUNS_TEXT), 4097])
def test_runs_of_each_class_match_jax(n):
    _check(RUNS_TEXT[:n])


def test_empty_and_padded_inputs():
    assert P.gpt_starts(np.zeros(0, np.uint32)).tolist() == []
    assert P.gpt_starts_device(np.zeros(0, np.uint32), device="cpu").size \
        == 0
    assert P.gpt_split_str("") == [] and P.gpt_chunk_lens_bytes(b"").size \
        == 0
    cls = torch.full((8,), 16, dtype=torch.int8)
    for n in (0, 1, 3):
        cls[:n] = 6
        want = np.asarray(_MASK_JNP(jnp.asarray(_padded(cls[:n].numpy())),
                                    jnp.int32(n)))[:8]
        np.testing.assert_array_equal(
            P.gpt_starts_mask_plain(cls, n).numpy(), want)
    assert P.gpt_starts_mask_plain(cls[:0], 0).shape == (0,)


def test_wrapper_on_the_cpu_runs_the_plain_version():
    cp = code_points(CASES[1] + RUNS_TEXT)
    cls = torch.from_numpy(P.class_table()[cp].astype(np.int8))
    n0 = P.gpt_starts_mask.launches
    got = P.gpt_starts_mask(cls, len(cp))
    assert P.gpt_starts_mask.launches == n0
    assert torch.equal(got, P.gpt_starts_mask_plain(cls, len(cp)))
    with pytest.raises(TypeError):
        P.gpt_starts_mask(cls.to(torch.int32), len(cp))
    with pytest.raises(ValueError):
        P.gpt_starts_mask(cls, len(cp) + 1)
    with pytest.raises(ValueError):
        P.gpt_starts_mask(cls, -1)


def test_device_splitter_defaults_to_the_card():
    """gpt_starts_device runs on the card unless asked for the CPU: with
    no card it raises resolve_device's error, with one it launches P1."""
    cp = code_points("we'll buy 123 apples!\n  next line")
    if not torch.cuda.is_available():
        with pytest.raises(ConfigError, match="needs a CUDA device"):
            P.gpt_starts_device(cp)
        return
    n0 = P.gpt_starts_mask.launches
    np.testing.assert_array_equal(P.gpt_starts_device(cp), P.gpt_starts(cp))
    assert P.gpt_starts_mask.launches == n0 + 3
