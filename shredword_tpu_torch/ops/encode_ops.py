"""BPE encoder of the port: the host side, the kernel's wrapper and its
plain PyTorch versions.

Semantics (the contract of ``tokenizer.merge`` and of the native CPU
encoder; the reference's merges table with base.py:22-36's
left-to-right overlap rule): per chunk, repeatedly substitute the
*lowest-rank* adjacent pair present, consuming overlapping runs greedily
left to right, until no adjacent pair is a known merge.

:func:`encode_core` encodes a stream of contiguous byte chunks and
replaces the JAX package's XLA merge loops, ``_encode_core`` (through
``_encode_device`` and ``_encode_device_hash``) and ``encode_flat``
(through ``encode_chunks``): on a CUDA tensor it runs
``csrc/encode.cu`` (lane groups per chunk; chunks of any length), on a
CPU tensor its plain versions, :func:`encode_core_plain` (chunks of at
most ``MAX_TW_LEN`` bytes, the locked-pair rounds over an [L, W] layout)
and :func:`encode_flat_plain` (any length, the flat-stream rounds).

The host entry points (:func:`encode_stream`, :func:`encode_ws_text`,
:func:`encode_chunks`) are the JAX package's, less what existed only for
XLA or the TPU: no power-of-two shape buckets, no length-bucketed blocks
(the kernel sorts no chunk into an [L, W] block), no splice of chunks
over 64 bytes (the kernel takes any length) and no dedup of repeated
chunks (on the H100 encoding every chunk was faster at 64 KB and 4 MB).
Like the JAX package's, a stream longer than ``STREAM_WINDOW_BYTES`` is
cut at chunk boundaries into windows of one device call each: a call
holds about 27 bytes of device memory per byte of whitespace-chunked
text, and the kernel takes its chunk count W and its length n as C
``int``s, which :func:`encode_core` refuses from 2^31 on.  Ids and the
per-group split are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels

RANK_INF = torch.iinfo(torch.int32).max

MAX_TW_LEN = 64      # longest chunk of encode_core_plain's [L, W] layout

# Above this vocab the dense v*v rank table (v*v*4 bytes; 64 MB at 4096)
# is replaced by the O(merges) hash-probe MergeTable.
DENSE_V_MAX = 4096

# One device call's stream window: encode_stream cuts longer streams at
# chunk boundaries.  No larger than the JAX package's 2^31 - 2^27; at
# 2^28 the 1 GB corpus's whitespace chunks peaked at 7.3 GB a call
# against 27.0 GB in one call (chip_smoke.py phase 22; NVIDIA H100 80GB
# HBM3, 700.00 W).
STREAM_WINDOW_BYTES = 2 ** 28

# encode_core's W and n reach csrc/encode.cu as C ints
C_INT_LIMIT = 2 ** 31


def _np_mix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # uint32 wraparound is the point of the mix; silence the warnings
    with np.errstate(over="ignore"):
        h = (a.astype(np.uint32) * np.uint32(0x9E3779B1)
             + b.astype(np.uint32) * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x045D9F3B)
        h ^= h >> np.uint32(16)
    return h


def _torch_mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_np_mix on int64 tensors, each step kept to 32 bits."""
    m = 0xFFFFFFFF
    h = ((a & m) * 0x9E3779B1 + (b & m) * 0x85EBCA6B) & m
    h ^= h >> 16
    h = (h * 0x045D9F3B) & m
    h ^= h >> 16
    return h


class MergeTable(NamedTuple):
    """Open-addressing pair -> rank table (int32 tensors on one device)."""

    ka: torch.Tensor     # int32[C] first id  (-1 = empty)
    kb: torch.Tensor     # int32[C] second id
    rank: torch.Tensor   # int32[C] merge rank (-1 = empty)
    max_probe: int       # probe bound
    v: int               # 256 + number of merges: every id is below it

    @property
    def capacity(self) -> int:
        return self.ka.shape[0]


def build_merge_table(merges: np.ndarray, device="cuda") -> MergeTable:
    """Host-side construction; the first occurrence of a pair wins
    (earliest rank), matching the reference trainer's dense-id
    invariant."""
    merges = np.asarray(merges, dtype=np.int32).reshape(-1, 2)
    n = len(merges)
    cap = 64
    while cap < 2 * n + 2:
        cap *= 2
    ka = np.full(cap, -1, np.int32)
    kb = np.full(cap, -1, np.int32)
    rk = np.full(cap, -1, np.int32)
    mask = cap - 1
    max_probe = 1
    for m in range(n):
        a, b = int(merges[m, 0]), int(merges[m, 1])
        slot = int(_np_mix(np.int32(a), np.int32(b))) & mask
        probes = 1
        while rk[slot] != -1:
            if ka[slot] == a and kb[slot] == b:
                break  # duplicate pair: keep earliest rank
            slot = (slot + 1) & mask
            probes += 1
        if rk[slot] == -1:
            ka[slot], kb[slot], rk[slot] = a, b, m
            max_probe = max(max_probe, probes)
    dev = torch.device(device)
    return MergeTable(torch.from_numpy(ka).to(dev),
                      torch.from_numpy(kb).to(dev),
                      torch.from_numpy(rk).to(dev), max_probe, 256 + n)


def build_rank_table(merges: np.ndarray, v: int,
                     device="cuda") -> torch.Tensor:
    """Dense flat pair -> rank table int32[v*v] built on the device
    (only the merge list is uploaded); RANK_INF = no merge.  The first
    occurrence of a pair wins (earliest rank); merges with a component
    outside [0, v) are dropped."""
    merges = np.asarray(merges, np.int32).reshape(-1, 2)
    ok = (merges >= 0).all(1) & (merges < v).all(1)
    dev = torch.device(device)
    keys = torch.from_numpy(merges[ok, 0].astype(np.int64) * v
                            + merges[ok, 1]).to(dev)
    ranks = torch.from_numpy(
        np.arange(len(merges), dtype=np.int32)[ok]).to(dev)
    table = torch.full((v * v,), RANK_INF, dtype=torch.int32, device=dev)
    return table.scatter_reduce_(0, keys, ranks, "amin")


def lookup_ranks_plain(table: MergeTable, a: torch.Tensor, b: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Elementwise pair -> rank through the hash table; RANK_INF where
    absent or not valid (``encode_ops.lookup_ranks`` of the JAX
    package)."""
    cap = table.capacity
    a64, b64 = a.long(), b.long()
    h = _torch_mix(a64, b64) & (cap - 1)
    rank = torch.full(a.shape, RANK_INF, dtype=torch.int32, device=a.device)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for k in range(table.max_probe):
        slot = (h + k) & (cap - 1)
        hit = (table.ka[slot] == a) & (table.kb[slot] == b)
        tr = table.rank[slot]
        rank = torch.where(hit & ~done, tr, rank)
        done = done | hit | (tr < 0)
    return torch.where(valid & (rank >= 0) & (rank < RANK_INF), rank,
                       RANK_INF)


def _rank_of(table, v: int):
    """``rank_of(a, b, valid)`` over the dense table or the hash table."""
    if isinstance(table, MergeTable):
        return lambda a, b, valid: lookup_ranks_plain(table, a, b, valid)

    def dense(a, b, valid):
        key = torch.where(valid, a.long() * v + b, 0)
        return torch.where(valid, table[key], RANK_INF)
    return dense


def out_dtype(v: int) -> torch.dtype:
    """The ids' storage type: int16 holding uint16 bits while every id
    fits in 16 bits (v <= 65536), else int32 (see :func:`ids_to_numpy`)."""
    return torch.int16 if v <= 65536 else torch.int32


def _to_out(ids: torch.Tensor, v: int) -> torch.Tensor:
    """int ids -> out_dtype(v), uint16 bits in int16 storage."""
    if out_dtype(v) == torch.int32:
        return ids.to(torch.int32)
    ids = ids.to(torch.int32)
    return torch.where(ids >= 32768, ids - 65536, ids).to(torch.int16)


def ids_to_numpy(ids: torch.Tensor) -> np.ndarray:
    """int32 numpy ids of :func:`encode_core`'s output."""
    arr = ids.cpu().numpy()
    if arr.dtype == np.int16:
        arr = arr.view(np.uint16)
    return arr.astype(np.int32)


# ---------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------

def encode_core(flat: torch.Tensor, lens: torch.Tensor, table, *, v: int,
                lookups: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode W contiguous chunks: chunk w is the bytes
    flat[start[w]:start[w] + lens[w]], start the exclusive cumsum of
    lens.  ``table`` is the dense rank table (:func:`build_rank_table`,
    int32 [v*v]) or a :class:`MergeTable`.  Returns (ids, counts): the
    ids of every chunk in chunk order, in :func:`out_dtype` (v) (uint16
    bits while v <= 65536), and int32 [W] ids per chunk.

    Replaces the JAX package's ``encode_ops._encode_core`` (through
    ``_encode_device`` / ``_encode_device_hash``, chunks of at most 64
    bytes) and ``encode_flat`` (through ``encode_chunks``, any length).
    CPU tensors run :func:`encode_core_plain` when every chunk is at most
    ``MAX_TW_LEN`` bytes, else :func:`encode_flat_plain`; CUDA tensors
    run ``csrc/encode.cu``: one launch that merges every chunk (lane
    groups by chunk length) and one that packs the ids, with a
    ``torch.cumsum`` of the counts between them; two launches per call,
    each counted in ``.launches``, and the host reads the ids' length
    once, after both.  A given
    ``lookups`` (int64 [1] on the card) gets the kernel's rank lookups
    added to it."""
    dense = not isinstance(table, MergeTable)
    tabs = (table,) if dense else (table.ka, table.kb, table.rank)
    if flat.dtype != torch.uint8 or flat.dim() != 1 \
            or lens.dtype != torch.int32 or lens.dim() != 1:
        raise TypeError("flat must be uint8 [N] and lens int32 [W]")
    if any(t.dtype != torch.int32 for t in tabs):
        raise TypeError("the rank table must be int32")
    if dense and table.shape != (v * v,):
        raise ValueError(f"dense table must be int32 [{v * v}], got "
                         f"{tuple(table.shape)}")
    if not dense and table.v > v:
        raise ValueError(f"the merge table's ids reach {table.v} > v {v}")
    if not all(t.is_contiguous() for t in (flat, lens, *tabs)):
        raise ValueError("flat, lens and the table must be contiguous")
    if len({t.device for t in (flat, lens, *tabs)}) != 1:
        raise ValueError("flat, lens and the table must share one device")
    dev = flat.device
    W = lens.shape[0]
    if W >= C_INT_LIMIT or flat.shape[0] >= C_INT_LIMIT:
        raise ValueError(f"encode_core takes fewer than {C_INT_LIMIT} "
                         f"chunks and bytes, got W {W}, n {flat.shape[0]}; "
                         f"encode_stream windows longer streams")
    if W and (int(lens.min()) < 0 or int(lens.sum()) > flat.shape[0]):
        raise ValueError("lens must be >= 0 and sum to at most len(flat)")
    if dev.type == "cpu":
        if W == 0:
            return (torch.zeros(0, dtype=out_dtype(v)),
                    torch.zeros(0, dtype=torch.int32))
        if int(lens.max()) <= MAX_TW_LEN:
            return encode_core_plain(flat, lens, table, v)
        return _flat_plain_counts(flat, lens, table, v)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lookups is not None and (lookups.dtype != torch.int64
                                or lookups.shape != (1,)
                                or lookups.device != dev):
        raise ValueError(f"lookups must be int64 [1] on {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty(W, **i32)
    if W == 0:
        return torch.empty(0, dtype=out_dtype(v), device=dev), counts
    start = torch.cumsum(lens, 0, dtype=torch.int64) - lens
    n = flat.shape[0]
    tok, rk = torch.empty(n, **i32), torch.empty(n, **i32)
    k = _kernels.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dense:
            targs = (table.data_ptr(), None, None, None, v, 0, 0)
        else:
            targs = (None, table.ka.data_ptr(), table.kb.data_ptr(),
                     table.rank.data_ptr(), v, table.capacity,
                     table.max_probe)
        _kernels._check(k.shred_encode_chunks(
            flat.data_ptr(), start.data_ptr(), lens.data_ptr(), W, *targs,
            tok.data_ptr(), rk.data_ptr(), counts.data_ptr(),
            None if lookups is None else lookups.data_ptr(), stream))
        encode_core.launches += 1
        ends = torch.cumsum(counts, 0, dtype=torch.int64)
        # at most one id a byte: pack into n slots, then read the length
        # once both launches are queued
        out = torch.empty(n, dtype=out_dtype(v), device=dev)
        _kernels._check(k.shred_encode_pack(
            tok.data_ptr(), start.data_ptr(), counts.data_ptr(),
            ends.data_ptr(), W, out.data_ptr(), out.element_size(), stream))
        encode_core.launches += 1
    return out[:int(ends[-1])], counts


encode_core.launches = 0


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def _shift_up_rows(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([x[1:], torch.full_like(x[:1], fill)])


def _take_row(x: torch.Tensor, idx: torch.Tensor,
              row: torch.Tensor) -> torch.Tensor:
    """x[idx[w], w] per column w; 0 where idx is out of range."""
    return torch.where(row == idx[None, :], x, 0).sum(0, dtype=x.dtype)


def encode_core_plain(flat: torch.Tensor, lens: torch.Tensor, table, v: int,
                      off: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`encode_core` for chunks of at most
    ``MAX_TW_LEN`` bytes: the JAX package's ``_encode_core`` step for
    step.  Column w of an int32 [L, W] layout holds chunk w (-1 padded);
    each column tracks a locked pair, merges the topmost remaining
    occurrence of it per round and relocks to its lowest rank when it is
    exhausted, with the rank of every adjacent pair kept up to date
    (only the two pairs touching the merge site are looked up again).
    ``off`` (int64 [W]) gives the chunks' offsets; None means contiguous.
    Returns (ids in :func:`out_dtype` (v), counts int32 [W]); the ids are
    the live cells column by column (the JAX package's sort-free packing
    gives the same order)."""
    rank_of = _rank_of(table, v)
    dev = flat.device
    W = lens.shape[0]
    lens = lens.to(torch.int32)
    if off is None:
        off = torch.cumsum(lens, 0) - lens
    L = max(int(lens.max()) if W else 1, 2)
    row = torch.arange(L, dtype=torch.int32, device=dev)[:, None].expand(L, W)
    gidx = torch.clamp(off[None, :] + row, max=flat.shape[0] - 1).long()
    tw = torch.where(row < lens[None, :], flat[gidx].to(torch.int32), -1)

    nxt0 = _shift_up_rows(tw, -1)
    rank = rank_of(tw, nxt0, (tw >= 0) & (nxt0 >= 0))
    t = tw
    la = torch.full((W,), -1, dtype=torch.int32, device=dev)
    lb = la.clone()
    lrk = torch.zeros(W, dtype=torch.int32, device=dev)
    L_sent = L                      # per-column "no site" sentinel
    while True:
        locked = la >= 0
        nxt = _shift_up_rows(t, -1)
        m = locked[None, :] & (t == la[None, :]) & (nxt == lb[None, :])
        occ = torch.where(m, row, L_sent).amin(0)
        exhausted = locked & (occ >= L_sent)
        rmin = rank.amin(0)
        can = rmin < RANK_INF
        rloc = torch.where(rank == rmin[None, :], row, L_sent).amin(0)
        relock = ~locked | exhausted
        set_lock = relock & can
        la = torch.where(set_lock, _take_row(t, rloc, row),
                         torch.where(relock, -1, la))
        lb = torch.where(set_lock, _take_row(t, rloc + 1, row),
                         torch.where(relock, -1, lb))
        lrk = torch.where(set_lock, rmin, lrk)
        site = torch.where(relock, torch.where(can, rloc, L_sent), occ)
        active = site < L_sent
        new_id = 256 + lrk

        # merge at `site` + single-shift compaction:
        # t'[j<s] = t[j]; t'[s] = new; t'[j>s] = t[j+1]
        tu = _shift_up_rows(t, -1)
        t2 = torch.where(row < site[None, :], t,
                         torch.where(row == site[None, :], new_id[None, :],
                                     tu))
        # rank shifts identically; only the two slots touching the site
        # change: (t[s-1], new) at row s-1 and (new, t[s+2]) at row s
        ru = _shift_up_rows(rank, RANK_INF)
        rank2 = torch.where(row < site[None, :] - 1, rank, ru)
        a_l = _take_row(t, site - 1, row)
        rank_l = rank_of(a_l, new_id, active & (site >= 1) & (a_l >= 0))
        b_r = torch.where(site + 2 < L, _take_row(t, site + 2, row), -1)
        rank_r = rank_of(new_id, b_r, active & (b_r >= 0))
        rank = torch.where(row == site[None, :] - 1, rank_l[None, :],
                           torch.where(row == site[None, :],
                                       rank_r[None, :], rank2))
        t = t2
        if not bool(active.any()):
            break
    live = t.t() >= 0
    counts = live.sum(1, dtype=torch.int32)
    return _to_out(t.t()[live], v), counts


class EncodeState(NamedTuple):
    tokens: torch.Tensor    # int32[N]
    chunk_id: torch.Tensor  # int32[N], -1 padding
    length: int


def encode_flat_plain(tokens: torch.Tensor, chunk_id: torch.Tensor,
                      length: int, table, *, num_chunks: int,
                      v: int | None = None) -> EncodeState:
    """The JAX package's ``encode_flat`` step for step, chunks of any
    length: a flat stream of int32 tokens with their chunk ids (-1
    padding past ``length``); per round every chunk merges all
    left-to-right occurrences of its lowest-rank pair (a segment min,
    then a parity scan over runs of matches) and the stream is
    compacted.  Ranks come from the hash table or (given ``v``) the
    dense table.  Returns the final state; its live prefix is
    ``length``."""
    n = tokens.shape[0]
    dev = tokens.device
    rank_of = _rank_of(table, v)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    st = EncodeState(tokens, chunk_id, length)

    def pair_ranks(st: EncodeState):
        t = st.tokens
        nxt = torch.roll(t, -1)
        w = st.chunk_id
        valid = (idx < st.length - 1) & (w == torch.roll(w, -1)) & (w >= 0)
        return rank_of(t, nxt, valid)

    r = pair_ranks(st)
    while bool((r < RANK_INF).any()):
        w = st.chunk_id
        seg = torch.where(w >= 0, w, 0).long()
        cmin = torch.full((num_chunks,), RANK_INF, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, seg, r, "amin")
        match = (r < RANK_INF) & (r == cmin[seg]) & (w >= 0)
        # parity scan: greedy left-to-right within runs of matches
        nm = torch.where(match, -1, idx)
        last_nm = torch.cummax(nm, 0).values
        sel = match & ((idx - last_nm - 1) % 2 == 0)

        t = torch.where(sel, 256 + r, st.tokens)
        killed = torch.roll(sel, 1)
        killed[0] = False
        keep = ~killed & (idx < st.length)
        pos = torch.cumsum(keep, 0) - 1
        dest = torch.where(keep, pos, n)
        out_t = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        out_c = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        out_t[dest] = t
        out_c[dest] = w
        st = EncodeState(out_t[:n], out_c[:n], int(keep.sum()))
        r = pair_ranks(st)
    return st


def _flat_plain_counts(flat, lens, table, v):
    """:func:`encode_core`'s contract through :func:`encode_flat_plain`."""
    W = lens.shape[0]
    n = int(lens.sum())
    cid = torch.repeat_interleave(
        torch.arange(W, dtype=torch.int32, device=flat.device), lens.long())
    st = encode_flat_plain(flat[:n].to(torch.int32), cid, n, table,
                           num_chunks=W, v=v)
    counts = torch.bincount(st.chunk_id[:st.length].long(),
                            minlength=W).to(torch.int32)
    return _to_out(st.tokens[:st.length], v), counts


# ---------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------

def _get_table(merges, v, _cache, device):
    key = ("table", v, str(device))
    if _cache is not None and key in _cache:
        return _cache[key]
    if v <= DENSE_V_MAX:
        table = build_rank_table(merges, v, device)
    else:
        table = build_merge_table(np.asarray(merges), device)
    if _cache is not None:
        _cache[key] = table
    return table


def _encode_contiguous(flat: np.ndarray, lens: np.ndarray, table, v: int,
                       device, counts: bool = True):
    """(ids int32 in chunk order, counts int64 per chunk or None) of
    contiguous chunks: one upload of the bytes and lengths, one
    :func:`encode_core` call, one download of the ids (and of the
    counts when asked)."""
    dev = torch.device(device)
    flat = np.ascontiguousarray(flat, np.uint8)
    if not flat.flags.writeable:        # a view of bytes
        flat = flat.copy()
    ids, cnt = encode_core(
        torch.from_numpy(flat).to(dev),
        torch.from_numpy(np.asarray(lens, np.int32)).to(dev), table, v=v)
    return (ids_to_numpy(ids),
            cnt.cpu().numpy().astype(np.int64) if counts else None)


def _ws_mask(flat: np.ndarray) -> np.ndarray:
    """Whether each byte is whitespace (space, tab, CR, LF)."""
    ws = flat == 32
    for b in (9, 13, 10):
        ws |= flat == b
    return ws


def ws_chunk_lens(flat: np.ndarray) -> np.ndarray:
    """Whitespace-keep chunk lengths (int64) of a byte stream (alternating
    word / whitespace runs, ws = space, tab, CR, LF: whitespace_keep_split's
    chunks), vectorized; at most two int64 arrays of the chunk count live
    at once."""
    n = len(flat)
    if n == 0:
        return np.zeros(0, np.int64)
    ws = _ws_mask(flat)
    cut = np.flatnonzero(ws[1:] != ws[:-1])     # a chunk ends at cut + 1
    del ws
    lens = np.empty(len(cut) + 1, np.int64)
    if len(cut) == 0:
        lens[0] = n
        return lens
    lens[0] = cut[0] + 1
    np.subtract(cut[1:], cut[:-1], out=lens[1:-1])
    lens[-1] = n - 1 - cut[-1]
    return lens


def _window_cuts(ends: np.ndarray) -> np.ndarray:
    """Chunk-index bounds [0, c1, ..., n] of the windows over chunks that
    end at the byte offsets ``ends``: each window ends at the last chunk
    boundary at or below ``STREAM_WINDOW_BYTES`` from its start, and
    holds at least one chunk (a longer chunk is a window of its own)."""
    n = len(ends)
    cuts = [0]
    while cuts[-1] < n:
        c0 = cuts[-1]
        start = int(ends[c0 - 1]) if c0 else 0
        c1 = int(np.searchsorted(ends, start + STREAM_WINDOW_BYTES,
                                 side="right"))
        cuts.append(max(c1, c0 + 1))
    return np.array(cuts, np.int64)


def stream_windows(lens: np.ndarray) -> np.ndarray:
    """Chunk-index bounds [0, c1, ..., n] of :func:`encode_stream`'s
    device calls over chunks of lengths ``lens`` (see
    :func:`_window_cuts`); one window when the stream fits."""
    if len(lens) == 0:
        return np.zeros(2, np.int64)
    return _window_cuts(np.cumsum(lens, dtype=np.int64))


# bytes a step of ws_windows' search for a chunk boundary looks at
WS_SCAN_BYTES = 1 << 16


def ws_windows(flat: np.ndarray) -> list[int]:
    """Byte bounds [0, b1, ..., n] of :func:`stream_windows`' windows over
    the whitespace-keep chunks of ``flat``, found without the chunk
    lengths: each cut is the last word / whitespace transition at or
    below ``STREAM_WINDOW_BYTES`` from the window's start, or the first
    after it when one chunk is longer.  A transition at byte p (ws[p - 1]
    != ws[p]) is sought in steps of ``WS_SCAN_BYTES``."""
    n = len(flat)
    bounds = [0]
    while n - bounds[-1] > STREAM_WINDOW_BYTES:
        b0 = bounds[-1]
        hi = b0 + STREAM_WINDOW_BYTES
        cut = None
        while cut is None and hi > b0:         # back from the window's end
            lo = max(b0, hi - WS_SCAN_BYTES)
            ws = _ws_mask(flat[lo:hi + 1])
            t = np.flatnonzero(ws[1:] != ws[:-1])
            cut = lo + int(t[-1]) + 1 if len(t) else None
            hi = lo
        lo = b0 + STREAM_WINDOW_BYTES
        while cut is None and lo < n - 1:      # the long chunk's end
            hi = min(n - 1, lo + WS_SCAN_BYTES)
            ws = _ws_mask(flat[lo:hi + 1])
            t = np.flatnonzero(ws[1:] != ws[:-1])
            cut = lo + int(t[0]) + 1 if len(t) else None
            lo = hi
        bounds.append(n if cut is None else cut)
    if bounds[-1] < n or n == 0:
        bounds.append(n)
    return bounds


def _encode_windows(flat: np.ndarray, lens: np.ndarray, table, v: int,
                    device, counts: bool):
    """:func:`_encode_contiguous` over the windows of
    :func:`stream_windows`: the ids and (when asked) the counts of every
    window, concatenated in chunk order.  The chunks' byte offsets are
    summed only when the stream is longer than a window."""
    if len(flat) <= STREAM_WINDOW_BYTES:
        return _encode_contiguous(flat, lens, table, v, device, counts)
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    cuts = _window_cuts(ends)
    ids, cnt = [], []
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        b0 = int(ends[c0 - 1]) if c0 else 0
        i, c = _encode_contiguous(flat[b0:int(ends[c1 - 1])], lens[c0:c1],
                                  table, v, device, counts)
        ids.append(i)
        cnt.append(c)
    return np.concatenate(ids), np.concatenate(cnt) if counts else None


def encode_stream(flat: np.ndarray, lens: np.ndarray, merges: np.ndarray,
                  v: int, group_bounds: np.ndarray | None = None,
                  _cache: dict | None = None,
                  device="cuda") -> list[np.ndarray]:
    """Encode a pre-chunked byte stream on ``device``; int32 ids per
    group.

    flat: uint8 bytes of all chunks, concatenated.
    lens: per-chunk byte lengths (any length).
    group_bounds: chunk-index boundaries [0, ..., n_chunks], one output
        array per group (e.g. one group per document).  Default: a
        single group.

    Every chunk goes through a device call, repeated chunks too: on the
    H100 that beat the JAX package's route through the distinct chunks
    (a native dedup pass, the device over the distinct chunks, a native
    expansion) at 64 KB and at 4 MB, for whitespace and GPT chunks alike
    (``chip_smoke.py`` phase 13).  A stream over ``STREAM_WINDOW_BYTES``
    takes one call per window of :func:`stream_windows`, as the JAX
    package's does; the per-chunk counts make the group split
    window-agnostic, so groups may span windows.  The rank table is
    built on the device and cached in ``_cache``.
    """
    n = len(lens)
    gbn = (np.array([0, n], np.int64) if group_bounds is None
           else np.asarray(group_bounds, np.int64))
    g = len(gbn) - 1
    if n == 0:
        return [np.zeros(0, np.int32)] * g
    table = _get_table(merges, v, _cache, device)
    ids, counts = _encode_windows(flat, lens, table, v, device,
                                  counts=g > 1)
    if g == 1:
        return [ids]
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=out_off[1:])
    return np.split(ids, out_off[gbn[1:-1]])


def encode_ws_text(flat: np.ndarray, merges: np.ndarray, v: int,
                   _cache: dict | None = None,
                   device="cuda") -> np.ndarray:
    """Whole-text encode over whitespace-keep chunking: the text is cut
    into :func:`ws_windows` (the windows :func:`encode_stream` would
    take), then per window the chunk lengths in one numpy pass and one
    device call over every chunk.  Chunks of any length take the same
    call (the JAX package returns None above 64 bytes and splices them
    in through encode_chunks; the ids are the same)."""
    flat = np.asarray(flat, np.uint8)
    if len(flat) == 0:
        return np.zeros(0, np.int32)
    table = _get_table(merges, v, _cache, device)
    bounds = ws_windows(flat)
    ids = [_encode_contiguous(flat[b0:b1], ws_chunk_lens(flat[b0:b1]),
                              table, v, device, counts=False)[0]
           for b0, b1 in zip(bounds[:-1], bounds[1:])]
    return ids[0] if len(ids) == 1 else np.concatenate(ids)


def encode_chunks(chunks: list[bytes], table: MergeTable,
                  return_chunk_ids: bool = False):
    """Encode a list of byte chunks of any length on the table's device,
    in :func:`encode_stream`'s windows; returns int32 ids (optionally
    with each id's chunk index)."""
    if not chunks:
        ids = np.zeros(0, np.int32)
        return (ids, ids) if return_chunk_ids else ids
    lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
    ids, counts = _encode_windows(np.frombuffer(b"".join(chunks), np.uint8),
                                  lens, table, table.v, table.ka.device,
                                  counts=return_chunk_ids)
    if return_chunk_ids:
        return ids, np.repeat(np.arange(len(chunks), dtype=np.int32), counts)
    return ids
