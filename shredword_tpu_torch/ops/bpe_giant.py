"""Giant-vocab BPE training, host side (port of
``shredword_tpu/ops/bpe_giant.py``): vocab up to 32768.

  table    int32 [v, v] exact pair counts in device memory (4.3 GB at
           v 32768), updated in place; row maxima int32 [v] kept as UPPER
           BOUNDS and confirmed lazily by the pick, the analogue of the
           reference's lazy heap (bpe.cpp:406-415)
  corpus   int16 [L, W], words SORTED BY LENGTH into chunks of
           ``chunk_width`` columns; an exact presence index int8 [v, NC]
           flags the chunks that hold both ids of a pair, and only those
           are read
  kernel   the merge loop of one call runs in ``_kernels.giant_train_step``
           (``csrc/giant.cu`` on the card, its plain PyTorch version on the
           CPU); the host reads 20 bytes of record per merge once per call

The initial ids are bytes (or, on resume, ids below 256 + the replayed
merges), so the initial table is built small and embedded into the
zeroed [v, v] table on the device: nothing quadratic in v is built on the
host.  Merge sequences, frequencies and final corpora are identical to
the JAX package's giant engine and to the flat engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels
from ..config import resolve_device
from ._kernels import PAD
from .bpe_hist import drive_calls, init_hist

C = 1024           # default chunk width
MXU_C = 512        # chunk widths stay multiples of the JAX package's
                   # scatter width, so the presence index keeps its shape
MAX_V = 32768      # int16 corpus ids
MAX_NC = 16384     # chunk bound of the JAX package (W <= MAX_NC * C words)


class GiantLayout(NamedTuple):
    tw: np.ndarray      # int16[L, W] tokens, words sorted by length
    wc: np.ndarray      # int32[1, W] word weights
    lens: np.ndarray    # int32[NC] max word length per chunk
    presT: np.ndarray   # int8[V, NC] exact token-in-chunk presence
    perm: np.ndarray    # int64[n_words] original word index per column
    n_words: int


def build_giant_layout(tokens: np.ndarray, word_id: np.ndarray,
                       wcount: np.ndarray, v: int,
                       max_word_len: int = 64,
                       cw: int = C) -> GiantLayout | None:
    """Length-sorted [L, W] layout + presence index; None if a word
    exceeds max_word_len or there are more than MAX_NC * cw words (the
    caller falls back to the flat engine).  wcount is per word.  Equal,
    array for array, to the JAX package's layout."""
    if len(tokens) == 0:
        return None
    n_words = int(word_id[-1]) + 1
    lens = np.bincount(word_id, minlength=n_words)
    L = int(lens.max(initial=1))
    if L > max_word_len:
        return None
    L = max(16, 1 << int(np.ceil(np.log2(L))))
    if n_words > MAX_NC * cw:
        return None
    perm = np.argsort(lens, kind="stable")          # short words first
    NC = max(1, -(-n_words // cw))
    NC = -(-NC // 128) * 128                        # presT lane multiple
    W = NC * cw
    tw = np.full((L, W), PAD, np.int16)
    starts = np.zeros(n_words + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    # column of word perm[j] is j: scatter token positions via inv perm
    inv = np.empty(n_words, np.int64)
    inv[perm] = np.arange(n_words)
    pos = np.arange(len(tokens)) - starts[word_id]
    tw[pos, inv[word_id]] = tokens
    wc = np.zeros((1, W), np.int32)
    wc[0, inv] = wcount
    chunk_lens = np.zeros(NC, np.int32)
    sorted_lens = lens[perm]
    nfull = n_words // cw
    if nfull:
        chunk_lens[:nfull] = sorted_lens[:nfull * cw].reshape(nfull, cw).max(1)
    if n_words % cw:
        chunk_lens[nfull] = sorted_lens[nfull * cw:].max(initial=0)
    presT = np.zeros((v, NC), np.int8)
    chunk_of = (inv[word_id] // cw).astype(np.int64)
    key = np.unique(tokens.astype(np.int64) * NC + chunk_of)
    presT[(key // NC).astype(np.int64), key % NC] = 1
    return GiantLayout(tw, wc, chunk_lens, presT, perm, n_words)


def init_tables(tw: torch.Tensor, wc: torch.Tensor, unk_id: int, v: int,
                id_bound: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial pair table int32 [v, v] and row maxima int32 [v] on tw's
    device.  The corpus holds ids below ``id_bound`` (256, or 256 + the
    replayed merges on resume), so the exact table is built as [vi, vi]
    with vi = id_bound rounded up to 128 and embedded into zeros."""
    vi = min(v, -(-max(id_bound, 256) // 128) * 128)
    small = init_hist(tw, wc, unk_id, vi)
    hist = torch.zeros((v, v), dtype=torch.int32, device=tw.device)
    hist[:vi, :vi] = small
    rowmax = torch.zeros(v, dtype=torch.int32, device=tw.device)
    rowmax[:vi] = small.amax(1)
    return hist, rowmax


def giant_state_from_jax(tw, wc, hist4, presT, rowmax, device="cuda"):
    """The JAX giant kernel's arrays (tw int16 [L, W], wc [1, W], hist4
    [v, v/128, 128], presT int8 [v, NC], rowmax [v/128, 128]) as the
    port's tensors (tw, wc [W], hist [v, v], presT, rowmax [v]): the
    same row-major bytes."""
    dev = resolve_device(device)
    hist4 = np.asarray(hist4, np.int32)
    return (torch.tensor(np.asarray(tw, np.int16), device=dev),
            torch.tensor(np.asarray(wc, np.int32).reshape(-1), device=dev),
            torch.tensor(hist4.reshape(hist4.shape[0], -1), device=dev),
            torch.tensor(np.asarray(presT, np.int8), device=dev),
            torch.tensor(np.asarray(rowmax, np.int32).reshape(-1),
                         device=dev))


def giant_state_to_jax(tw, wc, hist, presT, rowmax):
    """Inverse of :func:`giant_state_from_jax`, as numpy arrays."""
    v = hist.shape[0]
    return (tw.cpu().numpy(), wc.cpu().numpy().reshape(1, -1),
            hist.cpu().numpy().reshape(v, v // 128, 128),
            presT.cpu().numpy(), rowmax.cpu().numpy().reshape(v // 128, 128))


def giant_train(tokens: np.ndarray, word_id: np.ndarray,
                wcount: np.ndarray, *, target_merges: int,
                unk_id: int = -1, min_pair_freq: int = 2,
                max_word_len: int = 64, steps_per_call: int = 4096,
                progress_cb=None, lazy_final: bool = False,
                chunk_width: int | None = None, n_prev_merges: int = 0,
                device="cuda"):
    """Full driver: one upload, one kernel call per steps_per_call
    merges.  Returns (merges [M, 2], freqs [M], final tokens, final
    word_id) in the original word order, with a callable for the last two
    when lazy_final, or None if the problem is outside the engine's
    envelope (vocab > 32768, a word longer than max_word_len, unk_id >=
    256, more than MAX_NC * chunk_width unique words).  wcount is per
    word.

    Checkpoint resume: pass the REPLAYED corpus and ``n_prev_merges``;
    ``target_merges`` counts the previous merges too and only new merges
    are returned.  Runs on ``device``, the card by default."""
    dev = resolve_device(device)
    if chunk_width is None:
        # the JAX package widens the chunks for large word sets
        n_words = int(word_id.max()) + 1 if len(word_id) else 0
        cw = 2 * C if n_words > 1_500_000 else C
    else:
        cw = chunk_width
    if cw % MXU_C:
        raise ValueError(f"chunk_width must be a multiple of {MXU_C}")
    v = -(-(256 + target_merges) // 1024) * 1024
    if v > MAX_V or unk_id >= 256 or len(tokens) == 0:
        return None
    lay = build_giant_layout(tokens, word_id, wcount, v, max_word_len,
                             cw=cw)
    if lay is None:
        return None
    tw = torch.tensor(lay.tw, device=dev)           # trained in place
    wc = torch.tensor(lay.wc.reshape(-1), device=dev)
    presT = torch.tensor(lay.presT, device=dev)
    hist, rowmax = init_tables(tw, wc, unk_id, v,
                               id_bound=256 + n_prev_merges)
    nc_used = max(1, -(-lay.n_words // cw))

    def call(n_done, init_done, allowed, steps):
        return _kernels.giant_train_step(
            tw, wc, hist, presT, rowmax, unk=unk_id, min_freq=min_pair_freq,
            n_done=n_done, init_done=init_done, allowed=allowed,
            nc_used=nc_used, steps=steps)

    merges, freqs, _ = drive_calls(
        call, target_merges=target_merges, n_prev=n_prev_merges,
        steps_per_call=steps_per_call, progress_cb=progress_cb)
    perm = lay.perm
    n_words = lay.n_words

    def final_fn():
        """Materialize the final merged corpus in ORIGINAL word order
        (one device-to-host copy; undoes the length sort)."""
        twh = tw.cpu().numpy()
        cols = (twh >= 0).T                       # [W, L] valid positions
        col_lens = cols.sum(1)[:n_words]          # per sorted column
        toks_sorted = twh.T[:n_words][cols[:n_words]].astype(np.int32)
        starts = np.zeros(n_words + 1, np.int64)
        np.cumsum(col_lens, out=starts[1:])
        inv = np.empty(n_words, np.int64)
        inv[perm] = np.arange(n_words)            # original -> column
        out_lens = col_lens[inv]
        ostarts = np.zeros(n_words + 1, np.int64)
        np.cumsum(out_lens, out=ostarts[1:])
        total = int(ostarts[-1])
        pos_in_word = (np.arange(total, dtype=np.int64)
                       - np.repeat(ostarts[:-1], out_lens))
        order = np.repeat(starts[inv], out_lens) + pos_in_word
        final_tokens = toks_sorted[order]
        final_word_id = np.repeat(np.arange(n_words, dtype=np.int32),
                                  out_lens)
        return final_tokens, final_word_id

    if lazy_final:
        return merges, freqs, final_fn
    return (merges, freqs, *final_fn())
