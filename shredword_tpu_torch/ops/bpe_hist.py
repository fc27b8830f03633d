"""Histogram-engine BPE training, host side (port of
``shredword_tpu/ops/bpe_hist.py``).

  layout   tokens as int16 [L, W], one word per column, PAD = -3 after
           each word; weights int32 [W] per column
  hist     int32 [v, v] exact pair counts, maintained by per-merge
           deltas; ties break to the smallest row, then column
  kernel   the whole merge loop of one call runs in
           ``_kernels.hist_fused_train`` (CUDA on the card, its plain
           PyTorch version on the CPU); the host reads 16 bytes of
           record per merge once per call

Merge sequences, frequencies and final corpora are identical to the JAX
package's hist engine and to the flat engine (lex tie-break, greedy
left-to-right overlap rule, exact int32 counts).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import _kernels
from ._kernels import PAD

CHUNK = 512       # column padding of build_layout, as in the JAX package
MAX_V = 4096      # largest table of the fused engine; hist_train routes
                  # larger vocabularies to the giant engine (bpe_giant)


class HistCorpus(NamedTuple):
    tw: np.ndarray | torch.Tensor      # int16 [L, W]
    wcount: np.ndarray | torch.Tensor  # int32 [1, W] (host) / [W] (device)


class HistTrainState(NamedTuple):
    corpus: HistCorpus        # device tensors after training
    hist: torch.Tensor        # int32 [v, v]
    merges: np.ndarray        # int32 [n, 2], new merges only
    merge_freqs: np.ndarray   # int32 [n]
    n_merges: int
    done: bool


def build_layout(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, max_word_len: int,
                 min_len: int = 16) -> HistCorpus | None:
    """Pack the flat dedup stream into host arrays [L, W]; None if a word
    exceeds max_word_len (the caller falls back to the flat engine).
    wcount is per word."""
    if len(tokens) == 0:
        return None
    n_words = int(word_id[-1]) + 1
    lens = np.bincount(word_id, minlength=n_words)
    L = int(lens.max(initial=1))
    if L > max_word_len:
        return None
    L = max(min_len, 1 << int(np.ceil(np.log2(L))))
    W = -(-n_words // CHUNK) * CHUNK
    tw = np.full((L, W), PAD, np.int16)
    starts = np.zeros(n_words + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(len(tokens)) - starts[word_id]
    tw[pos, word_id] = tokens
    wc = np.zeros((1, W), np.int32)
    wc[0, :n_words] = wcount
    return HistCorpus(tw, wc)


def init_hist(tw: torch.Tensor, wcount: torch.Tensor, unk_id: int,
              v: int) -> torch.Tensor:
    """Exact initial pair table int32 [v, v] of the [L, W] corpus: pairs
    are vertically adjacent tokens of one column, unk and PAD excluded."""
    t = tw.to(torch.int32)
    nxt = torch.cat([t[1:], torch.full_like(t[:1], PAD)])
    w = wcount.reshape(1, -1).expand_as(t)
    valid = (t >= 0) & (nxt >= 0) & (t != unk_id) & (nxt != unk_id)
    key = (t[valid].long() * v + nxt[valid].long())
    hist = torch.zeros(v * v, dtype=torch.int32, device=tw.device)
    hist.index_add_(0, key, w[valid])
    return hist.view(v, v)


def state_from_jax(tw, wcount, hist, device="cpu"):
    """The JAX package's hist-engine arrays as the port's tensors.

    Accepts the ``HistCorpus`` layout (tw [L, W], wcount [1, W]) and the
    fused driver's layout (tw [NC, L, fc], wcount [NC, 1, fc]).  Returns
    (tw int16 [L, W], wcount int32 [W], hist int32 [v, v]) on device."""
    tw = np.asarray(tw)
    wcount = np.asarray(wcount)
    if tw.ndim == 3:
        nc, L, fc = tw.shape
        tw = tw.transpose(1, 0, 2).reshape(L, nc * fc)
    dev = torch.device(device)
    return (torch.tensor(np.asarray(tw, np.int16), device=dev),
            torch.tensor(np.asarray(wcount, np.int32).reshape(-1),
                         device=dev),
            torch.tensor(np.asarray(hist, np.int32), device=dev))


def state_to_jax(tw, wcount, hist, fc: int | None = None):
    """Inverse of :func:`state_from_jax`: numpy arrays in the
    ``HistCorpus`` layout, or in the fused layout when ``fc`` is given."""
    tw = tw.cpu().numpy()
    wcount = wcount.cpu().numpy()
    hist = hist.cpu().numpy()
    L, W = tw.shape
    if fc is None:
        return tw, wcount.reshape(1, W), hist
    nc = W // fc
    return (np.ascontiguousarray(tw.reshape(L, nc, fc).transpose(1, 0, 2)),
            wcount.reshape(nc, 1, fc), hist)


def drive_calls(call: Callable, *, target_merges: int, n_prev: int,
                steps_per_call: int, progress_cb: Callable | None = None
                ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Run a merge-loop kernel call after call up to target_merges.

    ``call(n_done, init_done, allowed, steps)`` runs ``steps`` merges and
    returns their int32 records [steps, >= 4] (a, b, freq, did, ...).
    Resume: n_prev merges were already replayed into the corpus by the
    caller; new ids continue at 256 + n_prev.  The done flag stops the
    loop once a call merges fewer pairs than it was allowed (exhaustion
    or min_pair_freq).  Returns the new merges int32 [n, 2], their
    frequencies int32 [n] and the done flag."""
    merges: list = []
    freqs: list = []
    done = 0
    while len(merges) + n_prev < target_merges and not done:
        allowed = target_merges - n_prev - len(merges)
        rows = call(n_prev + len(merges), done, allowed,
                    max(1, min(steps_per_call, allowed))).cpu().numpy()
        did = rows[:, 3] != 0
        n_new = int(did.sum())
        if n_new < len(rows):
            done = 1
        merges.extend(rows[did, 0:2].tolist())
        freqs.extend(rows[did, 2].tolist())
        if progress_cb is not None:
            progress_cb(np.asarray(merges, np.int32).reshape(-1, 2),
                        np.asarray(freqs, np.int32))
        if n_new == 0:
            break
    return (np.asarray(merges, np.int32).reshape(len(merges), 2),
            np.asarray(freqs, np.int32), bool(done))


def fused_hist_train(c: HistCorpus, v: int, *, target_merges: int,
                     unk_id: int, min_pair_freq: int, steps_per_call: int,
                     progress_cb: Callable | None = None, n_prev: int = 0,
                     device="cpu") -> HistTrainState:
    """Drive the fused merge loop to target_merges, steps_per_call
    merges per kernel call (see :func:`drive_calls`)."""
    dev = torch.device(device)
    tw = torch.tensor(c.tw, device=dev)             # copies: trained in place
    wc = torch.tensor(c.wcount.reshape(-1), device=dev)
    hist = init_hist(tw, wc, unk_id, v)

    def call(n_done, init_done, allowed, steps):
        return _kernels.hist_fused_train(
            tw, wc, hist, unk=unk_id, min_freq=min_pair_freq, n_done=n_done,
            init_done=init_done, allowed=allowed, steps=steps)

    merges, freqs, done = drive_calls(
        call, target_merges=target_merges, n_prev=n_prev,
        steps_per_call=steps_per_call, progress_cb=progress_cb)
    return HistTrainState(corpus=HistCorpus(tw, wc), hist=hist,
                          merges=merges, merge_freqs=freqs,
                          n_merges=len(merges), done=done)


def hist_train(tokens: np.ndarray, word_id: np.ndarray, wcount: np.ndarray,
               *, target_merges: int, unk_id: int = -1,
               min_pair_freq: int = 2, max_word_len: int = 64,
               max_steps_per_call: int | None = None, progress_cb=None,
               lazy_final: bool = False, n_prev_merges: int = 0,
               device="cpu"):
    """Full driver.  Returns (merges [M, 2], freqs [M], final flat tokens,
    final word_id), with a callable for the last two when lazy_final,
    or None if a word exceeds max_word_len.  wcount is per word.

    Vocabularies above MAX_V go to the giant engine, which may also
    return None (see ``bpe_giant.giant_train``).  The default cadence is
    512 merges per call for the fused engine and 4096 for the giant one;
    an explicit ``max_steps_per_call`` reaches either unchanged.

    Checkpoint resume: pass the REPLAYED corpus and ``n_prev_merges``;
    ``target_merges`` counts the previous merges too and only new merges
    are returned."""
    v = -(-(256 + target_merges) // 128) * 128
    if v > MAX_V:
        # beyond the fused engine's table: the giant engine (lazy row-max
        # pick, presence-indexed chunks) serves v <= 32768
        from . import bpe_giant
        return bpe_giant.giant_train(
            tokens, word_id, wcount, target_merges=target_merges,
            unk_id=unk_id, min_pair_freq=min_pair_freq,
            max_word_len=max_word_len,
            steps_per_call=(4096 if max_steps_per_call is None
                            else max_steps_per_call),
            progress_cb=progress_cb, lazy_final=lazy_final,
            n_prev_merges=n_prev_merges, device=device)
    steps = 512 if max_steps_per_call is None else max_steps_per_call
    c = build_layout(tokens, word_id, wcount, max_word_len, min_len=16)
    if c is None:
        return None
    ts = fused_hist_train(c, v, target_merges=target_merges, unk_id=unk_id,
                          min_pair_freq=min_pair_freq, steps_per_call=steps,
                          progress_cb=progress_cb, n_prev=n_prev_merges,
                          device=device)
    final_tw = ts.corpus.tw

    def final_fn():
        """Materialize the final merged corpus (one device-to-host copy)."""
        tw = final_tw.cpu().numpy()
        n_real_words = int(word_id[-1]) + 1   # padding columns beyond
        cols = (tw >= 0).T                    # [W, L]
        final_tokens = tw.T[cols]
        final_word_id = np.repeat(np.arange(tw.shape[1], dtype=np.int32),
                                  cols.sum(1))
        keep = final_word_id < n_real_words
        return (final_tokens[keep].astype(np.int32), final_word_id[keep])

    if lazy_final:
        return ts.merges, ts.merge_freqs, final_fn
    return (ts.merges, ts.merge_freqs, *final_fn())
