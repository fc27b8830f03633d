"""Unigram lattice ops of the port: the E-step forward-backward and the
Viterbi segmentation over word lattices, their kernel's wrappers and
their plain PyTorch versions.

Layout: the piece-id table of a slab of words is int32 [L, K, W] on the
device (cell (j, k, w): the piece of word w that starts at j with length
k + 1, -1 when absent), built once from the host's word-major
``native.piece_table`` ([W, L, K]) and permuted on the device, so that W
is innermost and a warp of ``csrc/unigram.cu`` reads 32 neighbouring
words' cells together.  The JAX package keeps [L, W, K] for its scan
(``device_table_from_jax`` / ``device_table_to_jax`` map the two).
Only the cells inside a word count (j + k + 1 <= its length), as
``piece_table`` fills them.

:func:`fb_core` replaces the JAX package's ``_fb_core`` (the E-step: the
expected count of every piece and the corpus log-likelihood) and
:func:`viterbi_core` its ``_viterbi_device`` plus the host backtrace of
``viterbi``; on a CUDA tensor each launches its kernel of
``csrc/unigram.cu`` (sixteen lanes per word), on a CPU tensor its plain
version (:func:`fb_core_plain`, :func:`viterbi_core_plain`).  The DP is
float32 in the JAX package's order of operations, with its subnormal
posteriors flushed to zero as XLA flushes them; the expected counts and
the log-likelihood are accumulated in float64 on both sides.  U1 sums
the counts of a slab's most frequent pieces (:func:`hot_ids`, kept with
the resident table) per block in shared memory.

One departure from the JAX package, in both versions: a posterior whose
product with its word's count overflows float32 counts as the word's
count (posterior 1).  It overflows only where a word's alpha is -1e30
or below (a word split only through pieces pruned to logp -1e30), where
the JAX package counts inf and its next M-step gives NaN log-probs;
wherever its counts are finite the results are the same.

Left out of the port: the JAX package's power-of-two buckets of W and of
the piece count (``_pow2``, ``nb``), which existed only to share XLA
executables across shapes; a CUDA kernel compiles once for every shape.
Padded words and pieces contribute nothing, so the counts and the
log-likelihood do not depend on them.  The numpy float64 forward-backward
(:func:`forward_backward` with backend "cpu", ``_fb_numpy``) is the JAX
package's "cpu" backend, copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..errors import EncodeError
from . import _kernels

NEG_INF = float("-inf")
FLT_MIN = float(np.finfo(np.float32).tiny)      # smallest normal float32
MAX_K = 15              # csrc/unigram.cu's KMAX, UnigramConfig's limit
LOCAL_L = 64            # the longest L the kernels keep in shared
                        # memory; a longer one takes global scratch
HOT_IDS = 1024          # csrc/unigram.cu's HOT_MAX: the ids a block of
                        # U1 sums in shared memory


# ---------------------------------------------------------------------
# the numpy float64 forward-backward (backend "cpu")
# ---------------------------------------------------------------------

def _tables(table: np.ndarray, logp: np.ndarray):
    """From a start-indexed id table [W, L, K] the scan tables:
    ids_s[j, w, k], the piece starting at j with length k + 1, and
    ids_e[j, w, k], the piece ending at j + 1 with length k + 1; lp with
    a -inf slot for the absent id."""
    W, L, K = table.shape
    ids_s = np.transpose(table, (1, 0, 2))          # [L, W, K]
    ids_e = np.full_like(ids_s, -1)
    for k in range(K):                              # end j+1 = start + k+1
        ids_e[k:, :, k] = ids_s[: L - k, :, k]
    lp = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    return ids_s, ids_e, lp


def _np_lse(x, axis):
    m = np.max(x, axis=axis)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(over="ignore"):
        s = np.sum(np.exp(x - np.expand_dims(safe, axis)), axis=axis)
    with np.errstate(divide="ignore"):
        return np.where(np.isfinite(m), safe + np.log(s), -np.inf)


def _fb_numpy(ids_s, ids_e, lp_ext, wlen, wcount, n_pieces: int):
    """The JAX package's vectorized host forward-backward (float64)."""
    L, W, K = ids_s.shape
    lp_s = lp_ext[np.where(ids_s >= 0, ids_s, n_pieces)]
    lp_e = lp_ext[np.where(ids_e >= 0, ids_e, n_pieces)]
    alpha = np.full((L + 1, W), -np.inf)
    alpha[0] = 0.0
    for j in range(1, L + 1):
        lo = max(0, j - K)
        win = alpha[lo:j][::-1]                      # [k], k=1..j-lo
        alpha[j] = _np_lse(win.T + lp_e[j - 1, :, :j - lo], axis=1)
    wl = wlen.astype(np.int64)
    alpha_n = alpha[wl, np.arange(W)]
    beta = np.full((L + 1, W), -np.inf)
    beta[wl, np.arange(W)] = 0.0
    for j in range(L - 1, -1, -1):
        hi = min(K, L - j)
        win = beta[j + 1:j + 1 + hi]                 # [k, W]
        cand = _np_lse(win.T + lp_s[j, :, :hi], axis=1)
        beta[j] = np.where(j == wl, 0.0, cand)
    norm = np.where(np.isfinite(alpha_n), alpha_n, 0.0)
    end = np.minimum(np.arange(L)[:, None, None] + np.arange(K) + 1, L)
    b_end = beta[end, np.arange(W)[None, :, None]]
    with np.errstate(over="ignore", invalid="ignore"):
        post = np.exp(alpha[:-1, :, None] + lp_s + b_end
                      - norm[None, :, None])
    post = np.where(ids_s >= 0, post * wcount[None, :, None], 0.0)
    # bincount is the C-speed scatter-add
    counts = np.bincount(
        np.where(ids_s >= 0, ids_s, n_pieces).reshape(-1),
        weights=post.reshape(-1), minlength=n_pieces + 1)[:n_pieces + 1]
    ll = float(np.sum(np.where(np.isfinite(alpha_n), alpha_n * wcount, 0.0)))
    return counts[:n_pieces], ll


# ---------------------------------------------------------------------
# device-resident tables (the EM path)
# ---------------------------------------------------------------------
#
# The piece-id table only changes at prune boundaries, and then only by
# an id permutation (a pruned piece's cells become -1; survivors
# renumber), so it lives on the device for the whole training run: built
# once per slab and remapped by a gather at every prune.

class HotIds(NamedTuple):
    """The piece ids to which U1 gives per-block shared accumulators."""

    ids: torch.Tensor           # int32 [H], H <= HOT_IDS, distinct
    slot: torch.Tensor          # int32 [S], S > every id of the table:
                                # slot[ids[i]] == i, else -1


def hot_ids(ids: torch.Tensor, h: int = HOT_IDS) -> HotIds:
    """The ``h`` piece ids that fill the most cells of a table (ties to
    the smaller id), and the map from every id to its place among them.
    On the table's device."""
    dev = ids.device
    occ = torch.bincount(ids[ids >= 0].long())
    top = torch.argsort(occ, descending=True, stable=True)[:h]
    slot = torch.full((occ.shape[0],), -1, dtype=torch.int32, device=dev)
    slot[top] = torch.arange(top.shape[0], dtype=torch.int32, device=dev)
    return HotIds(top.to(torch.int32), slot)


class DeviceTable:
    """One slab's resident lattice table, with its hot ids."""

    def __init__(self, ids, wlen, wcount, n_words: int):
        self.ids = ids              # int32 [L, K, W], -1 = absent
        self.wlen = wlen            # int32 [W]
        self.wcount = wcount        # float32 [W]
        self.n_words = n_words      # words (== W: the port pads nothing)
        self.hot = hot_ids(ids)


def _device_ids(table: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A start-indexed table (int32 [W, L, K], from ``native.piece_table``)
    uploaded and laid out [L, K, W] on the device."""
    ids = torch.from_numpy(np.ascontiguousarray(table, np.int32)).to(dev)
    return ids.permute(1, 2, 0).contiguous()


def make_device_table(table: np.ndarray, wlen: np.ndarray,
                      wcount: np.ndarray, device="cuda") -> DeviceTable:
    """Upload one slab's start-indexed table [W, L, K] and its words'
    lengths and counts."""
    dev = resolve_device(device)
    return DeviceTable(
        _device_ids(table, dev),
        torch.from_numpy(np.asarray(wlen, np.int32)).to(dev),
        torch.from_numpy(np.asarray(wcount, np.float32)).to(dev),
        table.shape[0])


def device_table_from_jax(ids_s: np.ndarray, wlen: np.ndarray,
                          wcount: np.ndarray, n_words: int,
                          device="cuda") -> DeviceTable:
    """The port's table from the JAX package's ``DeviceTable`` arrays
    (ids_s int32 [L, Wb, K], wlen [Wb], wcount [Wb], as numpy; Wb >=
    n_words, the padding dropped)."""
    dev = resolve_device(device)
    ids = np.asarray(ids_s, np.int32)[:, :n_words]
    return DeviceTable(
        torch.tensor(ids, device=dev).permute(0, 2, 1).contiguous(),
        torch.tensor(np.asarray(wlen[:n_words], np.int32), device=dev),
        torch.tensor(np.asarray(wcount[:n_words], np.float32), device=dev),
        n_words)


def device_table_to_jax(dt: DeviceTable):
    """The inverse of :func:`device_table_from_jax`: (ids_s int32
    [L, W, K], wlen int32 [W], wcount float32 [W], n_words), numpy."""
    return (dt.ids.permute(0, 2, 1).contiguous().cpu().numpy(),
            dt.wlen.cpu().numpy(), dt.wcount.cpu().numpy(), dt.n_words)


def remap_device_table(dt: DeviceTable, perm: np.ndarray) -> DeviceTable:
    """Renumber piece ids after a prune: perm[old] = new id, or -1 for a
    pruned piece.  One gather on the table's device; only the perm
    vector crosses the link."""
    ids = dt.ids
    perm_ext = torch.from_numpy(np.append(
        np.asarray(perm, np.int32), np.int32(-1))).to(ids.device)
    new = perm_ext[torch.where(ids >= 0, ids, len(perm)).long()]
    return DeviceTable(new, dt.wlen, dt.wcount, dt.n_words)


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------

def _check_lattice(ids, lp, wlen, wcount=None) -> int:
    """Types, shapes and values every lattice kernel takes: ids int32
    [L, K, W] with 1 <= K <= 15 and every id below len(lp); lp float32;
    wlen int32 [W] in [0, L]; wcount float32 [W]; contiguous, one
    device.  Returns the table's largest id (-1 when it has none)."""
    if ids.dtype != torch.int32 or lp.dtype != torch.float32 \
            or wlen.dtype != torch.int32 \
            or (wcount is not None and wcount.dtype != torch.float32):
        raise TypeError("ids and wlen must be int32, lp and wcount float32")
    if ids.dim() != 3 or lp.dim() != 1:
        raise ValueError(f"ids must be [L, K, W] and lp [n_pieces], got "
                         f"{tuple(ids.shape)} and {tuple(lp.shape)}")
    L, K, W = ids.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"piece lengths K must be in 1..{MAX_K}, got {K}")
    vecs = (wlen,) if wcount is None else (wlen, wcount)
    if any(v.shape != (W,) for v in vecs):
        raise ValueError(f"wlen and wcount must be [{W}]")
    tensors = (ids, lp, *vecs)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ids, lp, wlen and wcount must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ids, lp, wlen and wcount must share one device")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ids.device}")
    if W and ids.numel():
        hi, lmax, lmin = torch.stack([ids.max(), wlen.max(),
                                      wlen.min()]).tolist()
        if hi >= lp.shape[0]:
            raise ValueError(f"piece id {hi} >= n_pieces {lp.shape[0]}")
        if lmax > L or lmin < 0:
            raise ValueError(f"word lengths must be in [0, L={L}], got "
                             f"[{lmin}, {lmax}]")
        return hi
    return -1


def _check_hot(hot: HotIds, hi: int, device) -> None:
    """What U1 takes as hot ids: int32 vectors on the table's device, at
    most HOT_IDS ids, and a slot for every id up to ``hi``, the table's
    largest.  Their values are not read back: the kernel is safe with
    any, and :func:`hot_ids` builds a map whose counts are right."""
    ids, slot = hot
    if ids.dtype != torch.int32 or slot.dtype != torch.int32 \
            or ids.dim() != 1 or slot.dim() != 1:
        raise TypeError("hot ids and slots must be int32 vectors")
    if ids.device != device or slot.device != device \
            or not (ids.is_contiguous() and slot.is_contiguous()):
        raise ValueError("hot ids and slots must be contiguous, on the "
                         "table's device")
    if ids.shape[0] > HOT_IDS:
        raise ValueError(f"at most {HOT_IDS} hot ids, got {ids.shape[0]}")
    if slot.shape[0] <= hi:
        raise ValueError(f"hot slots must cover every id up to {hi}, got "
                         f"{slot.shape[0]}")


def fb_core(ids: torch.Tensor, lp: torch.Tensor, wlen: torch.Tensor,
            wcount: torch.Tensor, hot: HotIds | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The E-step over one slab: the expected count of every piece
    (float64 [n_pieces]: the posterior of each occurrence times its
    word's count) and the corpus log-likelihood (float64 [], alpha[len]
    times the count, over the segmentable words), on the tensors' device.

    ids int32 [L, K, W], lp float32 [n_pieces] (the pieces' log
    probabilities; -1e30 for a piece pruned to zero counts, finite),
    wlen int32 [W], wcount float32 [W]; ``hot``, the ids that U1 sums
    per block in shared memory, as :func:`hot_ids` builds them (the
    table's :class:`DeviceTable` ``.hot``; computed here when None).
    Replaces the JAX package's ``unigram_ops._fb_core``.  CPU tensors run
    :func:`fb_core_plain`; CUDA tensors run ``csrc/unigram.cu``'s
    ``fb_kernel`` (U1), one launch, which counts."""
    hi = _check_lattice(ids, lp, wlen, wcount)
    if hot is not None:
        _check_hot(hot, hi, ids.device)
    if ids.device.type == "cpu":
        return fb_core_plain(ids, lp, wlen, wcount)
    L, K, W = ids.shape
    dev = ids.device
    counts = torch.zeros(lp.shape[0], dtype=torch.float64, device=dev)
    ll = torch.zeros(1, dtype=torch.float64, device=dev)
    if W == 0:
        return counts, ll[0]
    if hot is None:
        hot = hot_ids(ids)
    H = hot.ids.shape[0]
    scratch = (torch.empty((L + 1) * W, dtype=torch.float32, device=dev)
               if L > LOCAL_L else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels._check(_kernels.lib().shred_unigram_fb(
            ids.data_ptr(), lp.data_ptr(), lp.shape[0], wlen.data_ptr(),
            wcount.data_ptr(), L, K, W, hot.ids.data_ptr() if H else None,
            hot.slot.data_ptr() if H else None, H,
            None if scratch is None else scratch.data_ptr(),
            counts.data_ptr(), ll.data_ptr(), stream))
    fb_core.launches += 1
    return counts, ll[0]


fb_core.launches = 0


def viterbi_core(ids: torch.Tensor, lp: torch.Tensor, wlen: torch.Tensor,
                 *, backtrace: bool = True):
    """Best segmentation of every word of one slab: (pieces int32 [L, W],
    each word's piece ids in order down its column and -1 below them;
    count int32 [W], their number, 0 when the word cannot be segmented;
    final float32 [W], the best path's score, -inf when it cannot be
    segmented and 0 for an empty word), on the tensors' device.  With
    ``backtrace=False`` only the scores: (None, None, final).

    Ties go to the shortest piece ending at a position (the JAX
    package's argmax takes the first maximum).  Replaces the JAX
    package's ``unigram_ops._viterbi_device`` and the host backtrace of
    its ``viterbi``.  CPU tensors run :func:`viterbi_core_plain`; CUDA
    tensors run ``csrc/unigram.cu``'s ``viterbi_kernel`` (U2), one
    launch, which counts."""
    _check_lattice(ids, lp, wlen)
    if ids.device.type == "cpu":
        return viterbi_core_plain(ids, lp, wlen, backtrace=backtrace)
    L, K, W = ids.shape
    dev = ids.device
    final = torch.empty(W, dtype=torch.float32, device=dev)
    out = count = None
    if backtrace:
        out = torch.full((L, W), -1, dtype=torch.int32, device=dev)
        count = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return out, count, final
    back = (torch.empty((L + 1) * W, dtype=torch.uint8, device=dev)
            if backtrace and L > LOCAL_L else None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels._check(_kernels.lib().shred_unigram_viterbi(
            ids.data_ptr(), lp.data_ptr(), wlen.data_ptr(), L, K, W,
            ptr(back), ptr(out), ptr(count), final.data_ptr(), stream))
    viterbi_core.launches += 1
    return out, count, final


viterbi_core.launches = 0


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def _cell_lp(ids, lp, wlen) -> torch.Tensor:
    """float32 [L, K, W]: lp of every cell inside its word, -inf for the
    absent cells and the cells past the word's end."""
    L, K, _ = ids.shape
    dev = ids.device
    end = (torch.arange(L, device=dev)[:, None, None]
           + torch.arange(1, K + 1, device=dev)[None, :, None])
    inside = (ids >= 0) & (end <= wlen[None, None, :])
    return torch.where(inside, lp[ids.clamp(min=0).long()],
                       torch.tensor(NEG_INF, device=dev))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x (>= 0) with float32 subnormals set to 0, as XLA flushes them on
    the CPU and the TPU (see csrc/unigram.cu)."""
    return torch.where(x < FLT_MIN, 0.0, x)


def _lse0(c: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp over dim 0 as the JAX package's _lse: -inf where no
    entry is finite."""
    m = c.amax(0)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, 0.0)
    s = torch.exp(c - safe).sum(0)
    return torch.where(fin, safe + torch.log(s), NEG_INF)


def _ending_at(x: torch.Tensor, lpc: torch.Tensor, e: int) -> torch.Tensor:
    """[k, W]: x[s] + lp of the cell (s, k) for every piece of length
    k + 1 ending at e (start s = e - k - 1 >= 0)."""
    kk = torch.arange(min(lpc.shape[1], e), device=lpc.device)
    s = e - 1 - kk
    return x[s] + lpc[s, kk]


def fb_core_plain(ids, lp, wlen, wcount) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version of :func:`fb_core`: the same float32 DP, the
    positions in lockstep over every word, and an ``index_add_`` of the
    posteriors into float64 counts.  A posterior whose product with the
    count overflows counts as the word's count, as in the kernel."""
    L, K, W = ids.shape
    dev = ids.device
    f32 = dict(dtype=torch.float32, device=dev)
    lpc = _cell_lp(ids, lp, wlen)
    alpha = torch.full((L + 1, W), NEG_INF, **f32)
    alpha[0] = 0.0
    for e in range(1, L + 1):
        alpha[e] = _lse0(_ending_at(alpha, lpc, e))
    cols = torch.arange(W, device=dev)
    wl = wlen.long()
    norm = alpha[wl, cols]
    beta = torch.full((L + 1, W), NEG_INF, **f32)
    beta[L] = torch.where(wl == L, 0.0, NEG_INF)
    for j in range(L - 1, -1, -1):
        kk = torch.arange(min(K, L - j), device=dev)
        cand = _lse0(beta[j + 1 + kk] + lpc[j, kk])
        beta[j] = torch.where(wl == j, 0.0, cand)
    end = (torch.arange(L, device=dev)[:, None]
           + torch.arange(1, K + 1, device=dev)[None, :]).clamp(max=L)
    ok = torch.isfinite(lpc) & torch.isfinite(norm)[None, None, :]
    post = _flush(_flush(torch.exp(((alpha[:L, None, :] + lpc) + beta[end])
                                   - norm[None, None, :])) * wcount)
    # an overflowed posterior counts as 1 (see the module's notes)
    post = torch.where(torch.isfinite(post), post, wcount)
    counts = torch.zeros(lp.shape[0], dtype=torch.float64, device=dev)
    counts.index_add_(0, ids[ok].long(), post[ok].double())
    fin = torch.isfinite(norm)
    ll = torch.where(fin, norm * wcount, 0.0).sum(dtype=torch.float64)
    return counts, ll


def viterbi_core_plain(ids, lp, wlen, *, backtrace: bool = True):
    """Plain PyTorch version of :func:`viterbi_core`: the max-plus DP in
    lockstep over every word (ties to the smallest k, the first maximum),
    then the backtraces in lockstep."""
    L, K, W = ids.shape
    dev = ids.device
    lpc = _cell_lp(ids, lp, wlen)
    score = torch.full((L + 1, W), NEG_INF, dtype=torch.float32, device=dev)
    score[0] = 0.0
    back = torch.zeros((L + 1, W), dtype=torch.long, device=dev)
    for e in range(1, L + 1):
        c = _ending_at(score, lpc, e)
        score[e] = c.amax(0)
        back[e] = (c == score[e]).int().argmax(0)
    cols = torch.arange(W, device=dev)
    wl = wlen.long()
    final = torch.where(wl > 0, score[wl, cols], 0.0)
    if not backtrace:
        return None, None, final
    j = torch.where(torch.isfinite(final), wl, 0)
    count = torch.zeros(W, dtype=torch.long, device=dev)
    rev = torch.full((L, W), -1, dtype=torch.int32, device=dev)
    for i in range(L):
        live = j > 0
        if not bool(live.any()):
            break
        k = back[j, cols]
        start = (j - k - 1).clamp(min=0)
        rev[i] = torch.where(live, ids[start, k, cols], -1)
        count += live.long()
        j = torch.where(live, start, j)
    # rev holds each path from its end; out[i] = rev[count - 1 - i]
    src = count[None, :] - 1 - torch.arange(L, device=dev)[:, None]
    out = torch.where(src >= 0, rev.gather(0, src.clamp(min=0)), -1)
    return out.to(torch.int32), count.to(torch.int32), final


# ---------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------

def forward_backward_resident(dt: DeviceTable, logp: np.ndarray,
                              n_pieces: int) -> tuple[np.ndarray, float]:
    """Expected counts (float64 [n_pieces]) and the log-likelihood of a
    resident slab, :func:`fb_core` on its device."""
    lp = torch.from_numpy(np.asarray(logp[:n_pieces], np.float32)).to(
        dt.ids.device)
    counts, ll = fb_core(dt.ids, lp, dt.wlen, dt.wcount, dt.hot)
    return counts.cpu().numpy(), float(ll)


def forward_backward(table: np.ndarray, wlen: np.ndarray,
                     wcount: np.ndarray, logp: np.ndarray, n_pieces: int,
                     backend: str = "cuda", device="cuda"):
    """Expected piece counts and the corpus log-likelihood of a slab.

    table: int32 [W, L, K] start-indexed piece ids (-1 = absent).
    backend "cpu": the numpy float64 forward-backward; "cuda":
    :func:`fb_core` on ``device``."""
    if backend == "cpu":
        ids_s, ids_e, lp_ext = _tables(table, logp)
        return _fb_numpy(ids_s, ids_e, lp_ext, wlen,
                         wcount.astype(np.float64), n_pieces)
    dt = make_device_table(table, wlen, wcount, device)
    return forward_backward_resident(dt, logp, n_pieces)


def _upload(table, wlen, logp, device):
    """viterbi_core's arguments on ``device``: ids, lp, wlen."""
    dev = resolve_device(device)
    return (_device_ids(table, dev),
            torch.from_numpy(np.asarray(logp, np.float32)).to(dev),
            torch.from_numpy(np.asarray(wlen, np.int32)).to(dev))


def viterbi_scores(table: np.ndarray, wlen: np.ndarray, logp: np.ndarray,
                   device="cuda") -> np.ndarray:
    """Each word's best-path score (float64 [W] of the float32 scores;
    -inf when it cannot be segmented, 0 for an empty word):
    :func:`viterbi_core` without its backtrace."""
    _, _, final = viterbi_core(*_upload(table, wlen, logp, device),
                               backtrace=False)
    return final.cpu().numpy().astype(np.float64)


def viterbi(table: np.ndarray, wlen: np.ndarray, logp: np.ndarray,
            return_scores: bool = False, device="cuda"):
    """Batched Viterbi segmentation: a list of piece-id lists (and the
    per-word best-path scores when ``return_scores``), by one
    :func:`viterbi_core` call on ``device``.  A word that cannot be
    segmented raises EncodeError, or gets [] when ``return_scores``."""
    out, count, final = viterbi_core(*_upload(table, wlen, logp, device))
    out = out.cpu().numpy().T
    count = count.cpu().numpy()
    final = final.cpu().numpy().astype(np.float64)
    segs = []
    for w_i in range(table.shape[0]):
        if wlen[w_i] > 0 and not np.isfinite(final[w_i]):
            if return_scores:          # the caller handles it
                segs.append([])
                continue
            raise EncodeError(
                f"word {w_i} cannot be segmented with this piece set "
                "(missing byte pieces)")
        segs.append(out[w_i, :count[w_i]].tolist())
    if return_scores:
        return segs, final
    return segs
