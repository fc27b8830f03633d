"""Histogram-engine BPE training, host side (port of
``shredword_tpu/ops/bpe_hist.py``).

  layout   tokens as int16 [L, W], one word per column, PAD = -3 after
           each word; weights int32 [W] per column
  hist     int32 [v, v] exact pair counts, maintained by per-merge
           deltas; ties break to the smallest row, then column
  fused    the whole merge loop of one call runs in
           ``_kernels.hist_fused_train`` (CUDA on the card, its plain
           PyTorch version on the CPU); the host reads 16 bytes of
           record per merge once per call.  The main path.
  sparse   ``hist_train(sparse=True)``: the same loop with a corpus pass
           over only the chunks whose presence holds the pair
           (``_kernels.hist_sparse_train``, K5, one persistent launch
           per call)
  sharded  ``parallel/hist.py``: the merge chain on one rank's columns
           with an all-reduce of the deltas per merge
           (``_kernels.hist_sharded_train``, K4, one launch per merge).
           ``make_train_loop`` and ``make_train_loop_sparse`` are the
           JAX package's per-call forms of the K4 and K5 loops.

Merge sequences, frequencies and final corpora are identical to the JAX
package's hist engine and to the flat engine (lex tie-break, greedy
left-to-right overlap rule, exact int32 counts).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import _kernels
from ..config import resolve_device
from ._kernels import CHUNK, PAD

MAX_V = 4096      # largest table of the fused engine; hist_train routes
                  # larger vocabularies to the giant engine (bpe_giant)


class HistCorpus(NamedTuple):
    tw: np.ndarray | torch.Tensor      # int16 [L, W]
    wcount: np.ndarray | torch.Tensor  # int32 [1, W] (host) / [W] (device)


class HistTrainState(NamedTuple):
    corpus: HistCorpus        # device tensors: tw [L, W], wcount [W]
    hist: torch.Tensor        # int32 [v, v]
    merges: np.ndarray        # int32 [M_max, 2]; slot k is merge k
    merge_freqs: np.ndarray   # int32 [M_max]
    n_merges: int             # including the n_prev resumed merges
    done: bool


def build_layout(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, max_word_len: int,
                 min_len: int = 16, dtype=np.int16) -> HistCorpus | None:
    """Pack the flat dedup stream into host arrays [L, W] of ``dtype``
    (int32 where ids pass 32767); None if a word exceeds max_word_len
    (the caller falls back to the flat engine).  wcount is per word."""
    if len(tokens) == 0:
        return None
    n_words = int(word_id[-1]) + 1
    lens = np.bincount(word_id, minlength=n_words)
    L = int(lens.max(initial=1))
    if L > max_word_len:
        return None
    L = max(min_len, 1 << int(np.ceil(np.log2(L))))
    W = -(-n_words // CHUNK) * CHUNK
    tw = np.full((L, W), PAD, dtype)
    starts = np.zeros(n_words + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    pos = np.arange(len(tokens)) - starts[word_id]
    tw[pos, word_id] = tokens
    wc = np.zeros((1, W), np.int32)
    wc[0, :n_words] = wcount
    return HistCorpus(tw, wc)


def pair_keys(tw: torch.Tensor, wcount: torch.Tensor, unk_id: int,
              v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pair occurrence of the [L, W] corpus as the int64 key
    a * v + b and its column's int32 weight: pairs are vertically
    adjacent tokens of one column, unk and PAD excluded."""
    t = tw.long()
    nxt = torch.cat([t[1:], torch.full_like(t[:1], PAD)])
    w = wcount.reshape(1, -1).expand_as(t)
    valid = (t >= 0) & (nxt >= 0) & (t != unk_id) & (nxt != unk_id)
    return t[valid] * v + nxt[valid], w[valid]


def init_hist(tw: torch.Tensor, wcount: torch.Tensor, unk_id: int,
              v: int) -> torch.Tensor:
    """Exact initial pair table int32 [v, v] of the [L, W] corpus
    (:func:`pair_keys`)."""
    hist = torch.zeros(v * v, dtype=torch.int32, device=tw.device)
    hist.index_add_(0, *pair_keys(tw, wcount, unk_id, v))
    return hist.view(v, v)


def state_from_jax(tw, wcount, hist, device="cuda", presence=None):
    """The JAX package's hist-engine arrays as the port's tensors.

    Accepts the ``HistCorpus`` layout (tw [L, W], wcount [1, W]) and the
    fused driver's layout (tw [NC, L, fc], wcount [NC, 1, fc]).  Returns
    (tw int16 [L, W], wcount int32 [W], hist int32 [v, v]) on device,
    and presT int8 [v, NC] when the sparse step's ``presence`` (int32
    [NC, 8, v], 8 equal rows) is given."""
    tw = np.asarray(tw)
    wcount = np.asarray(wcount)
    if tw.ndim == 3:
        nc, L, fc = tw.shape
        tw = tw.transpose(1, 0, 2).reshape(L, nc * fc)
    dev = resolve_device(device)
    out = (torch.tensor(np.asarray(tw, np.int16), device=dev),
           torch.tensor(np.asarray(wcount, np.int32).reshape(-1),
                        device=dev),
           torch.tensor(np.asarray(hist, np.int32), device=dev))
    if presence is None:
        return out
    pres = np.asarray(presence)[:, 0, :].T.astype(np.int8)
    return (*out, torch.tensor(np.ascontiguousarray(pres), device=dev))


def state_to_jax(tw, wcount, hist, fc: int | None = None, presT=None):
    """Inverse of :func:`state_from_jax`: numpy arrays in the
    ``HistCorpus`` layout, or in the fused layout when ``fc`` is given;
    with ``presT``, the sparse step's presence int32 [NC, 8, v] too."""
    tw = tw.cpu().numpy()
    wcount = wcount.cpu().numpy()
    hist = hist.cpu().numpy()
    L, W = tw.shape
    if fc is None:
        out = (tw, wcount.reshape(1, W), hist)
    else:
        nc = W // fc
        out = (np.ascontiguousarray(
            tw.reshape(L, nc, fc).transpose(1, 0, 2)),
            wcount.reshape(nc, 1, fc), hist)
    if presT is None:
        return out
    pres = presT.cpu().numpy().T.astype(np.int32)            # [NC, v]
    return (*out, np.ascontiguousarray(
        np.broadcast_to(pres[:, None, :], (pres.shape[0], 8,
                                           pres.shape[1]))))


def build_presence(tw: np.ndarray, v: int) -> np.ndarray:
    """int8 [v, NC]: 1 iff the id occurs in chunk c (columns
    [c * CHUNK, (c + 1) * CHUNK)) of the [L, W] layout; built once on the
    host, then the sparse step keeps it exact for the chunks it
    processes.  The JAX package stores the same bits as int32 [NC, 8, v]
    (eight equal rows, a TPU tiling artifact; see
    :func:`state_from_jax`)."""
    L, W = tw.shape
    nc = W // CHUNK
    t = np.asarray(tw).reshape(L, nc, CHUNK).astype(np.int64)
    chunk = np.broadcast_to(np.arange(nc)[None, :, None], t.shape)
    ok = (t >= 0) & (t < v)
    pres = np.zeros((v, nc), np.int8)
    pres[t[ok], chunk[ok]] = 1
    return pres


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


def _drive_state(ts: HistTrainState, call: Callable, *, target_merges: int,
                 n_prev: int, steps_per_call: int,
                 progress_cb: Callable | None) -> HistTrainState:
    """:func:`drive_calls` from the fresh state ``ts`` (its corpus and
    table are what ``call`` trains in place); returns ts with the
    records."""
    merges, freqs, done = drive_calls(
        call, target_merges=target_merges, n_prev=n_prev,
        steps_per_call=steps_per_call, progress_cb=progress_cb)
    n = n_prev + len(merges)
    ts.merges[n_prev:n] = merges
    ts.merge_freqs[n_prev:n] = freqs
    return ts._replace(n_merges=n, done=done)


def fused_hist_train(c: HistCorpus, v: int, *, target_merges: int,
                     unk_id: int, min_pair_freq: int, steps_per_call: int,
                     progress_cb: Callable | None = None, n_prev: int = 0,
                     device="cuda") -> HistTrainState:
    """Drive the fused merge loop to target_merges, steps_per_call
    merges per kernel call (see :func:`drive_calls`)."""
    ts = hist_train_init(c, unk_id, target_merges, v, device=device)
    (tw, wc), hist = ts.corpus, ts.hist

    def call(n_done, init_done, allowed, steps):
        return _kernels.hist_fused_train(
            tw, wc, hist, unk=unk_id, min_freq=min_pair_freq, n_done=n_done,
            init_done=init_done, allowed=allowed, steps=steps)

    return _drive_state(ts, call, target_merges=target_merges, n_prev=n_prev,
                        steps_per_call=steps_per_call,
                        progress_cb=progress_cb)


# ---------------------------------------------------------------------
# per-merge train loops (K4, K5)
# ---------------------------------------------------------------------

def loop_call(ts: HistTrainState, kernel: Callable, *extra,
              target_merges: int, max_steps: int, unk_id: int,
              min_pair_freq: int) -> HistTrainState:
    """One call of a per-merge train loop: up to max_steps merges of
    ``kernel`` (:func:`_kernels.hist_sharded_train` or
    :func:`_kernels.hist_sparse_train`, with ``extra`` state after the
    table) on ts's corpus and table, stopping at done or target_merges
    like the JAX loop's ``cond_fn``; the records are read once."""
    k = min(max_steps, target_merges - ts.n_merges)
    if ts.done or k <= 0:
        return ts
    (tw, wc), hist = ts.corpus, ts.hist
    rows = kernel(tw, wc, hist, *extra, unk=unk_id, min_freq=min_pair_freq,
                  n_done=ts.n_merges, init_done=0, allowed=k,
                  steps=k).cpu().numpy()
    did = rows[:, 3] != 0
    n0, n = ts.n_merges, int(did.sum())
    ts.merges[n0:n0 + n] = rows[did, :2]
    ts.merge_freqs[n0:n0 + n] = rows[did, 2]
    return ts._replace(n_merges=n0 + n, done=n < k)


def hist_train_init(c: HistCorpus, unk_id: int, max_merges: int, v: int,
                    device="cuda") -> HistTrainState:
    """State of the per-merge loops: the layout on device, its exact
    table, empty records; callers seed n_merges on resume."""
    dev = resolve_device(device)
    tw = torch.tensor(np.asarray(c.tw, np.int16), device=dev)
    wc = torch.tensor(np.asarray(c.wcount, np.int32).reshape(-1),
                      device=dev)
    return HistTrainState(
        corpus=HistCorpus(tw, wc), hist=init_hist(tw, wc, unk_id, v),
        merges=np.zeros((max(max_merges, 1), 2), np.int32),
        merge_freqs=np.zeros(max(max_merges, 1), np.int32),
        n_merges=0, done=False)


def _check_loop_state(ts: HistTrainState, v: int, L: int, W: int) -> None:
    if tuple(ts.corpus.tw.shape) != (L, W) or ts.hist.shape != (v, v):
        raise ValueError(f"state does not match the loop: tw "
                         f"{tuple(ts.corpus.tw.shape)} vs {(L, W)}, hist "
                         f"{tuple(ts.hist.shape)} vs {(v, v)}")


def make_train_loop(v: int, L: int, W: int, *, target_merges: int,
                    max_steps: int) -> Callable:
    """The per-merge train loop (JAX ``make_train_loop``):
    ``train_loop(ts, unk_id, min_pair_freq) -> ts`` runs up to max_steps
    merges of the K4 chain (:func:`_kernels.hist_sharded_train` on one
    rank)."""

    def train_loop(ts: HistTrainState, unk_id: int,
                   min_pair_freq: int) -> HistTrainState:
        _check_loop_state(ts, v, L, W)
        return loop_call(ts, _kernels.hist_sharded_train,
                         target_merges=target_merges, max_steps=max_steps,
                         unk_id=unk_id, min_pair_freq=min_pair_freq)

    return train_loop


def make_train_loop_sparse(v: int, L: int, W: int, *, target_merges: int,
                           max_steps: int) -> Callable:
    """:func:`make_train_loop` with the chunk-skipping K5 loop
    (:func:`_kernels.hist_sparse_train`):
    ``train_loop(ts, presT, unk_id, min_pair_freq) -> ts``, presT int8
    [v, W / CHUNK] updated in place."""

    def train_loop(ts: HistTrainState, presT: torch.Tensor, unk_id: int,
                   min_pair_freq: int) -> HistTrainState:
        _check_loop_state(ts, v, L, W)
        return loop_call(ts, _kernels.hist_sparse_train, presT,
                         target_merges=target_merges, max_steps=max_steps,
                         unk_id=unk_id, min_pair_freq=min_pair_freq)

    return train_loop


def _sparse_drive(c: HistCorpus, v: int, unk_id: int, min_pair_freq: int,
                  target_merges: int, max_steps: int, progress_cb=None,
                  device="cuda") -> HistTrainState:
    ts = hist_train_init(c, unk_id, target_merges, v, device=device)
    (tw, wc), hist = ts.corpus, ts.hist
    presT = torch.tensor(build_presence(c.tw, v), device=hist.device)

    def call(n_done, init_done, allowed, steps):
        return _kernels.hist_sparse_train(
            tw, wc, hist, presT, unk=unk_id, min_freq=min_pair_freq,
            n_done=n_done, init_done=init_done, allowed=allowed, steps=steps)

    return _drive_state(ts, call, target_merges=target_merges, n_prev=0,
                        steps_per_call=max_steps, progress_cb=progress_cb)


def hist_train(tokens: np.ndarray, word_id: np.ndarray, wcount: np.ndarray,
               *, target_merges: int, unk_id: int = -1,
               min_pair_freq: int = 2, max_word_len: int = 64,
               max_steps_per_call: int | None = None, sparse: bool = False,
               progress_cb=None, lazy_final: bool = False,
               n_prev_merges: int = 0, device="cuda"):
    """Full driver.  Returns (merges [M, 2], freqs [M], final flat tokens,
    final word_id), with a callable for the last two when lazy_final,
    or None if a word exceeds max_word_len.  wcount is per word.

    Vocabularies above MAX_V go to the giant engine, which may also
    return None (see ``bpe_giant.giant_train``).  The default cadence is
    512 merges per call for the fused and sparse engines and 4096 for the
    giant one; an explicit ``max_steps_per_call`` reaches each unchanged.
    ``sparse`` trains with the chunk-skipping loop (K5) when
    nothing is resumed, as the JAX package does; otherwise the fused
    kernel runs.

    Checkpoint resume: pass the REPLAYED corpus and ``n_prev_merges``;
    ``target_merges`` counts the previous merges too and only new merges
    are returned.

    Runs on ``device``, the card by default; without one, pass
    ``device="cpu"`` (the kernels' plain versions)."""
    device = resolve_device(device)
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
    ts = None
    if sparse and n_prev_merges == 0:
        ts = _sparse_drive(c, v, unk_id, min_pair_freq, target_merges,
                           steps, progress_cb, device)
    if ts is None:
        ts = fused_hist_train(c, v, target_merges=target_merges,
                              unk_id=unk_id, min_pair_freq=min_pair_freq,
                              steps_per_call=steps, progress_cb=progress_cb,
                              n_prev=n_prev_merges, device=device)
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

    merges = ts.merges[n_prev_merges:ts.n_merges]
    freqs = ts.merge_freqs[n_prev_merges:ts.n_merges]
    if lazy_final:
        return merges, freqs, final_fn
    return (merges, freqs, *final_fn())
