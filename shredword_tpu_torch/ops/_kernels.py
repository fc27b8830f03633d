"""Hand-written CUDA kernels of the port: build, load and wrappers.

The sources under ``shredword_tpu_torch/csrc`` are compiled at first use
with ``nvcc`` for ``sm_90a`` (one compiler per source, in parallel) into
a shared library with a plain C interface, named by a content hash of
every file under csrc/ and the flags (as ``shredword_tpu/runtime/build.py``
names the native runtime), and loaded with ctypes.  Importing this module
builds nothing.

Every wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; it never falls back from one to
the other.  Each wrapper counts its kernel launches in ``.launches``.
The wrappers of the BPE training kernels (K1-K5, the row-sharded
giant step G1, the flat engine's loop F1 and its sharded loop S1) live
here; the encoder's
(``csrc/encode.cu``) is ``encode_ops.encode_core`` and the Unigram
lattice kernels' (``csrc/unigram.cu``) are ``unigram_ops.fb_core`` and
``unigram_ops.viterbi_core``, and the GPT splitter's (``csrc/pretok.cu``)
is ``pretok_ops.gpt_starts_mask``, each beside its plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from . import bpe_ops

PAD = -3
CHUNK = 512       # columns per chunk of the hist layout (its W is a
                  # multiple) and per presence bit of the sparse step

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ["hist_fused.cu", "giant.cu", "hist_step.cu", "encode.cu",
           "unigram.cu", "giant_sharded.cu", "pretok.cu", "flat.cu",
           "flat_sharded.cu"]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# the persistent kernels read data that other blocks of the same launch
# wrote: their global loads bypass the SMs' incoherent L1 caches
SOURCE_FLAGS = {s: ["-Xptxas", "-dlcm=cg"]
                for s in ("hist_fused.cu", "giant.cu", "hist_step.cu",
                          "giant_sharded.cu")}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def lib_path() -> str:
    """The library's path, named by a hash of every file under csrc/
    (sources and headers) and of the flags."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return os.path.join(BUILD_DIR, f"libshred_cuda-{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed:\n{' '.join(cmd)}"
                               f"\n{out}")
    return "".join(outs)


def build(extra_flags: tuple[str, ...] = (),
          out: str | None = None) -> tuple[str, str]:
    """Compile the kernel library unless it is already built: one nvcc
    per source, all at once, then one link.  Returns (path, compiler
    output); extra_flags (e.g. ``-Xptxas -v``) force a rebuild so their
    output is shown.  ``out`` builds to another path (a library built
    with other defines)."""
    if out is None:
        out = lib_path()
        if os.path.exists(out) and not extra_flags:
            return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        log = _run_all([[_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(s, []),
                         *extra_flags, "-c", "-o", o,
                         os.path.join(CSRC_DIR, s)]
                        for s, o in zip(SOURCES, objs)])
        so = os.path.join(tmp, "lib.so")
        log += _run_all([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", so, *objs]])
        os.replace(so, out)
    return out, log


def bind(path: str) -> ctypes.CDLL:
    """Load the kernel library at ``path`` and declare its C functions."""
    L = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    L.shred_hist_fused_train.argtypes = [p] * 7 + [i] * 9 + [p]
    L.shred_hist_fused_train.restype = i
    L.shred_giant_train.argtypes = [p] * 10 + [i] * 12 + [p]
    L.shred_giant_train.restype = i
    L.shred_hist_sparse_train.argtypes = [p] * 8 + [i] * 10 + [p]
    L.shred_hist_sparse_train.restype = i
    L.shred_hist_chain_init.argtypes = [p] * 4 + [i] + [p]
    L.shred_hist_chain_init.restype = i
    L.shred_hist_chain_step.argtypes = [p] * 7 + [i] * 10 + [p]
    L.shred_hist_chain_step.restype = i
    L.shred_encode_chunks.argtypes = ([p] * 3 + [i] + [p] * 4 + [i] * 3
                                      + [p] * 5)
    L.shred_encode_chunks.restype = i
    L.shred_encode_pack.argtypes = [p] * 4 + [i, p, i, p]
    L.shred_encode_pack.restype = i
    L.shred_unigram_fb.argtypes = ([p, p, i, p, p] + [i] * 3 + [p, p, i]
                                   + [p] * 4)
    L.shred_unigram_fb.restype = i
    L.shred_unigram_viterbi.argtypes = [p] * 3 + [i] * 3 + [p] * 5
    L.shred_unigram_viterbi.restype = i
    L.shred_giant_sharded_train.argtypes = [p] * 9 + [i] * 13 + [p]
    L.shred_giant_sharded_train.restype = i
    for f in (L.shred_giant_sharded_apply_pick, L.shred_giant_sharded_merge):
        f.argtypes = [p] * 9 + [i] * 14 + [p]
        f.restype = i
    L.shred_gpt_starts_mask.argtypes = [p, i, p, p, p]
    L.shred_gpt_starts_mask.restype = i
    L.shred_gpt_status_ints.argtypes = [i]
    L.shred_gpt_status_ints.restype = i
    L.shred_flat_train.argtypes = [p] * 14 + [i] * 9 + [p]
    L.shred_flat_train.restype = i
    L.shred_flat_sharded_step.argtypes = [p] * 19 + [i] * 14 + [p]
    L.shred_flat_sharded_step.restype = i
    L.shred_cuda_error_string.argtypes = [i]
    L.shred_cuda_error_string.restype = ctypes.c_char_p
    return L


def lib() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def _check(rc: int) -> None:
    if rc != 0:
        msg = lib().shred_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA launch failed: {msg} ({rc})")


# ---------------------------------------------------------------------
# fused hist-engine merge loop
# ---------------------------------------------------------------------

def _check_hist_args(tw, wcount, hist, *, n_done, allowed, steps) -> None:
    """The checks every hist-table wrapper makes: tw int16 [L, W],
    wcount int32 [W], hist int32 [v, v], contiguous, on one device."""
    L, W = tw.shape
    v = hist.shape[0]
    if tw.dtype != torch.int16 or wcount.dtype != torch.int32 \
            or hist.dtype != torch.int32:
        raise TypeError("tw must be int16, wcount and hist int32")
    if wcount.shape != (W,) or hist.shape != (v, v):
        raise ValueError(f"shape mismatch: tw {tuple(tw.shape)}, wcount "
                         f"{tuple(wcount.shape)}, hist {tuple(hist.shape)}")
    if not (tw.is_contiguous() and wcount.is_contiguous()
            and hist.is_contiguous()):
        raise ValueError("tw, wcount and hist must be contiguous")
    if L not in (16, 32, 64):
        raise ValueError(f"word rows L must be 16, 32 or 64, got {L}")
    if 256 + n_done + min(steps, allowed) > v:
        raise ValueError("merge ids would exceed the table size v")
    if not (tw.device == wcount.device == hist.device):
        raise ValueError("tw, wcount and hist must share one device")
    if tw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tw.device}")
    if tw.device.type == "cuda" and v % 4:
        raise ValueError(f"the kernel needs v a multiple of 4, got {v}")


def _launch_scratch(v: int, steps: int, dev,
                    rowmax=None) -> tuple[torch.Tensor, ...]:
    """rowmax int32 [2v] ((max, arg) per row; the caller's when given),
    two delta buffers int32 [2, 2v] and records int32 [steps, 4] for a
    hist-table kernel."""
    i32 = dict(dtype=torch.int32, device=dev)
    if rowmax is None:
        rowmax = torch.empty(2 * v, **i32)
    elif rowmax.dtype != torch.int32 or rowmax.shape != (2 * v,) \
            or rowmax.device != dev or not rowmax.is_contiguous():
        raise ValueError(f"rowmax must be contiguous int32 [{2 * v}] on "
                         f"{dev}")
    return (rowmax, torch.empty((2, 2 * v), **i32),
            torch.empty((steps, 4), **i32))


def table_rowmax_plain(hist: torch.Tensor) -> torch.Tensor:
    """int32 [2v]: the (max, smallest column holding it) of every row of
    hist int32 [v, v], interleaved, as the hist-table kernels keep it."""
    m = hist.amax(1)
    arg = (hist == m[:, None]).int().argmax(1).int()
    return torch.stack([m, arg], 1).reshape(-1)


def hist_fused_train(tw: torch.Tensor, wcount: torch.Tensor,
                     hist: torch.Tensor, *, unk: int, min_freq: int,
                     n_done: int, init_done: int, allowed: int,
                     steps: int) -> torch.Tensor:
    """``steps`` greedy merges of the hist engine, in place.

    Replaces ``shredword_tpu.ops.bpe_hist._fused_kernel`` and
    ``_fused_kernel_big`` (one launch each, same semantics): tw int16
    [L, W] (one word per column, PAD after it), wcount int32 [W],
    hist int32 [v, v].  The scalars are the TPU kernel's ``scal``
    (unk_id, min_pair_freq, n_done, init_done, allowed); merge step i
    creates id 256 + n_done + i.  Returns int32 [steps, 4] records
    (a, b, freq, did) on tw's device; did == 0 from the first step that
    could not merge on (the done flag is sticky).

    CPU tensors run :func:`hist_fused_train_plain`; CUDA tensors run
    ``csrc/hist_fused.cu``: one persistent launch for all ``steps``
    (bound by the grid barriers of each merge's chain, see its
    header)."""
    kw = dict(n_done=n_done, allowed=allowed, steps=steps)
    _check_hist_args(tw, wcount, hist, **kw)
    if tw.device.type == "cpu":
        return hist_fused_train_plain(tw, wcount, hist, unk=unk,
                                      min_freq=min_freq,
                                      init_done=init_done, **kw)
    L, W = tw.shape
    v = hist.shape[0]
    rowmax, d, records = _launch_scratch(v, steps, tw.device)
    with torch.cuda.device(tw.device):
        stream = torch.cuda.current_stream(tw.device).cuda_stream
        rc = lib().shred_hist_fused_train(
            tw.data_ptr(), wcount.data_ptr(), hist.data_ptr(),
            rowmax.data_ptr(), d[0].data_ptr(), d[1].data_ptr(),
            records.data_ptr(), L, W, v, steps, unk, min_freq, n_done,
            init_done, allowed, stream)
    _check(rc)
    hist_fused_train.launches += 1
    return records


hist_fused_train.launches = 0


def apply_hist_updates(hist: torch.Tensor, a: int, b: int, new: int,
                       dl: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """The five exact table updates of a merge, in place and in the JAX
    order (bpe_hist.py:251-259): column a -= dl, column new += dl, row
    b -= dr, row new += dr, cell (a, b) = 0.  The order matters when
    a == b or a neighbour is a or b."""
    hist[:, a] -= dl
    hist[:, new] += dl
    hist[b, :] -= dr
    hist[new, :] += dr
    hist[a, b] = 0
    return hist


def merge_steps(hist: torch.Tensor, step, *, min_freq: int, n_done: int,
                init_done: int, allowed: int, steps: int) -> torch.Tensor:
    """The plain version of every hist-table kernel's merge loop:
    ``steps`` greedy merges, each the pick, ``step(a, b, new) -> (dl,
    dr)`` (the corpus pass; int32 [v] each) and
    :func:`apply_hist_updates`.

    The pick is the JAX one (``make_train_loop``): the argmax over the
    thresholded flat table, ties to the smallest flat index, i.e. the
    smallest row of the largest thresholded row maximum, then its
    smallest column.  Merge step i creates id 256 + n_done + i.  Returns
    int32 [steps, 4] records (a, b, freq, did): from the first step that
    cannot merge on, (0, 0, freq, 0), as nothing changes any more."""
    records = torch.zeros((steps, 4), dtype=torch.int32, device=hist.device)
    for i in range(steps):
        rm = hist.amax(1)
        rm = torch.where(rm >= min_freq, rm, 0)
        m = int(rm.max())
        if not (m > 0 and not init_done and i < allowed):
            records[i:, 2] = m
            break
        a = int((rm == m).nonzero()[0, 0])          # smallest row
        b = int((hist[a] == m).nonzero()[0, 0])     # then smallest column
        new = 256 + n_done + i
        records[i] = torch.tensor([a, b, m, 1], dtype=torch.int32)
        apply_hist_updates(hist, a, b, new, *step(a, b, new))
    return records


def hist_fused_train_plain(tw, wcount, hist, *, unk, min_freq, n_done,
                           init_done, allowed, steps) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_fused_train`: the closed-form
    select/compact/delta pass over the whole [L, W] corpus inside
    :func:`merge_steps`."""
    v = hist.shape[0]
    return merge_steps(
        hist, lambda a, b, new: merge_pass_plain(tw, wcount, a, b, new, unk,
                                                 v)[:2],
        min_freq=min_freq, n_done=n_done, init_done=init_done,
        allowed=allowed, steps=steps)


def _shift_down(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[r - k] (rows), ``fill`` for r < k."""
    return torch.cat([torch.full_like(x[:k], fill), x[:-k]])


def _shift_up(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[r + k] (rows), ``fill`` past the end."""
    return torch.cat([x[k:], torch.full_like(x[:k], fill)])


def merge_pass_plain(tw, wcount, a, b, new, unk, v):
    """Merge (a, b) -> new over the [L, W] corpus (int16 or int32) in
    place; returns the int32 [v] left/right neighbour weight vectors
    (dl, dr) and the number of merged occurrences nm
    (bpe_hist._select_and_apply + _slot_delta_accum semantics)."""
    L, W = tw.shape
    t = tw.to(torch.int32, copy=True)     # tw is rewritten below
    m = (t == a) & (_shift_up(t, 1, PAD) == b)
    dl = torch.zeros(v, dtype=torch.int32, device=tw.device)
    dr = torch.zeros_like(dl)
    if not bool(m.any()):
        return dl, dr, 0
    # greedy left-to-right: every other match of a run, from its head
    row = torch.arange(L, device=tw.device)[:, None]
    last_nm = torch.where(m, -1, row).cummax(0).values
    sel = m & (((row - last_nm) & 1) == 1)
    # merge, then compact each column over the holes left by b
    hole = _shift_down(sel, 1, False)
    keep = ~hole
    pos = torch.where(keep, keep.cumsum(0) - 1, L)
    out = torch.full((L + 1, W), PAD, dtype=torch.int32, device=tw.device)
    out.scatter_(0, pos, torch.where(sel, new, t))
    tw.copy_(out[:L])
    # neighbour weights: left is the token emitted before (new when the
    # previous pair merged), right the pre-merge t[r + 2]
    lval = torch.where(_shift_down(sel, 2, False), new,
                       _shift_down(t, 1, PAD))
    rval = _shift_up(t, 2, PAD)
    w = wcount.expand(L, W)
    for vals, d in ((lval, dl), (rval, dr)):
        ok = sel & (vals >= 0) & (vals != unk)
        d.index_add_(0, vals[ok].long(), w[ok])
    return dl, dr, int(sel.sum())


# ---------------------------------------------------------------------
# giant-vocab merge loop
# ---------------------------------------------------------------------

def giant_train_step(tw: torch.Tensor, wcount: torch.Tensor,
                     hist: torch.Tensor, presT: torch.Tensor,
                     rowmax: torch.Tensor, *, unk: int, min_freq: int,
                     n_done: int, init_done: int, allowed: int,
                     nc_used: int, steps: int) -> torch.Tensor:
    """``steps`` greedy merges of the giant engine, in place.

    Replaces ``shredword_tpu.ops.bpe_giant._giant_kernel`` (one launch,
    same semantics): tw int16 [L, W] (words sorted by length into NC
    chunks of W // NC columns), wcount int32 [W], hist int32 [v, v],
    presT int8 [v, NC] (exact presence of each id in each chunk), rowmax
    int32 [v] (upper bounds of the row maxima).  The scalars are the TPU
    kernel's ``scal`` (unk_id, min_pair_freq, n_done, init_done, allowed,
    nc_used); merge step i creates id 256 + n_done + i.  Returns int32
    [steps, 5] records (a, b, freq, did, n_refresh) on tw's device, where
    n_refresh counts the pick's row reads; did == 0 from the first step
    that could not merge on (the done flag is sticky).

    CPU tensors run :func:`giant_train_step_plain`; CUDA tensors run
    ``csrc/giant.cu``: one persistent launch for all ``steps`` (bound by
    the grid barriers of each merge's chain and the pick's row reads, see
    its header)."""
    L, W = tw.shape
    v, NC = presT.shape
    if tw.dtype != torch.int16 or presT.dtype != torch.int8 or any(
            x.dtype != torch.int32 for x in (wcount, hist, rowmax)):
        raise TypeError("tw must be int16, presT int8, wcount, hist and "
                        "rowmax int32")
    if wcount.shape != (W,) or hist.shape != (v, v) \
            or rowmax.shape != (v,) or W % NC or v % 128:
        raise ValueError(
            f"shape mismatch (v a multiple of 128): tw {tuple(tw.shape)}, "
            f"wcount {tuple(wcount.shape)}, hist {tuple(hist.shape)}, presT "
            f"{tuple(presT.shape)}, rowmax {tuple(rowmax.shape)}")
    tensors = (tw, wcount, hist, presT, rowmax)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("tw, wcount, hist, presT and rowmax must be "
                         "contiguous")
    if L not in (16, 32, 64):
        raise ValueError(f"word rows L must be 16, 32 or 64, got {L}")
    cw = W // NC
    if cw % 256:
        raise ValueError(f"chunk width {cw} must be a multiple of 256")
    if not 1 <= nc_used <= NC:
        raise ValueError(f"nc_used {nc_used} must be in [1, {NC}]")
    if 256 + n_done + min(steps, allowed) > v:
        raise ValueError("merge ids would exceed the table size v")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("tw, wcount, hist, presT and rowmax must share "
                         "one device")
    kw = dict(unk=unk, min_freq=min_freq, n_done=n_done,
              init_done=init_done, allowed=allowed, nc_used=nc_used,
              steps=steps)
    if tw.device.type == "cpu":
        return giant_train_step_plain(*tensors, **kw)
    if tw.device.type != "cuda":
        raise ValueError(f"unsupported device {tw.device}")
    dev = tw.device
    i32 = dict(dtype=torch.int32, device=dev)
    dl = torch.empty(2 * v, **i32)           # two buffers used in turn
    dr = torch.empty(2 * v, **i32)
    # chunk bits | 8-byte group keys
    bits = torch.empty(NC + NC % 2 + v // 16, **i32)
    state = torch.empty(16, **i32)           # row-read keys, maxima slots
    records = torch.empty((steps, 5), **i32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().shred_giant_train(
            tw.data_ptr(), wcount.data_ptr(), hist.data_ptr(),
            presT.data_ptr(), rowmax.data_ptr(), dl.data_ptr(),
            dr.data_ptr(), bits.data_ptr(), state.data_ptr(),
            records.data_ptr(), L, W, v, NC, cw, nc_used, steps, unk,
            min_freq, n_done, init_done, allowed, stream)
    _check(rc)
    giant_train_step.launches += 1
    return records


giant_train_step.launches = 0


def _lazy_pick(hist, rowmax, min_freq) -> tuple[int, int, int]:
    """(freq m, row a, row reads): the largest thresholded bound, its
    row read and the bound refreshed until it is confirmed exact."""
    n_refresh = 0
    while True:
        n_refresh += 1
        rm = torch.where(rowmax >= min_freq, rowmax, 0)
        m = int(rm.max())
        if m <= 0:
            return m, 0, n_refresh
        a = int((rm == m).nonzero()[0, 0])          # smallest row
        true_max = int(hist[a].max())
        if true_max == m:
            return m, a, n_refresh
        rowmax[a] = true_max


def giant_train_step_plain(tw, wcount, hist, presT, rowmax, *, unk,
                           min_freq, n_done, init_done, allowed, nc_used,
                           steps) -> torch.Tensor:
    """Plain PyTorch version of :func:`giant_train_step`: the same lazy
    pick and bound rules, and :func:`chunk_pass_plain` over the flagged
    chunks."""
    dev = tw.device
    records = torch.zeros((steps, 5), dtype=torch.int32, device=dev)
    done = bool(init_done)
    for i in range(steps):
        m, a, n_refresh = _lazy_pick(hist, rowmax, min_freq)
        if not (m > 0 and not done and i < allowed):
            # nothing changes any more: every later step confirms the
            # same pick with one row read
            records[i] = torch.tensor([0, 0, m, 0, n_refresh])
            records[i + 1:] = torch.tensor([0, 0, m, 0, 1])
            break
        b = int((hist[a] == m).nonzero()[0, 0])     # then smallest column
        new = 256 + n_done + i
        records[i] = torch.tensor([a, b, m, 1, n_refresh])
        # corpus: only chunks that hold both a and b can match
        dl, dr = chunk_pass_plain(tw, wcount, presT, a, b, new, unk,
                                  hist.shape[0], nc_used)
        # table, in the TPU kernel's order, with its row-max bound rules
        hist[b] -= dr
        rowmax[b] = hist[b].max()
        hist[new] = dr
        hist[:, a] -= dl
        hist[:, new] += dl
        hist[a, b] = 0
        torch.maximum(rowmax, dl, out=rowmax)
        rowmax[new] = hist[new].max()
        rowmax[a] = hist[a].max()
    return records


# ---------------------------------------------------------------------
# the row-sharded giant merge step (G1)
# ---------------------------------------------------------------------

def pick_key(m: int, a: int, b: int) -> int:
    """The 64-bit key of a pick (freq m of pair (a, b), ids < 65536): its
    maximum over the ranks is the largest freq, then the smallest a, then
    the smallest b."""
    return (m << 32) | ((65535 - a) << 16) | (65535 - b)


def giant_sharded_train(tw: torch.Tensor, wcount: torch.Tensor,
                        hist: torch.Tensor, bounds: torch.Tensor,
                        presT: torch.Tensor, *, base: int, reduce_key=None,
                        reduce_deltas=None, unk: int, min_freq: int,
                        n_done: int, init_done: int, allowed: int,
                        nc_used: int, steps: int) -> torch.Tensor:
    """``steps`` greedy merges of the row-sharded giant engine on one
    rank, in place.

    Replaces the per-merge body of ``shredword_tpu.parallel.giant``
    (``shard_body`` of ``build_sharded_giant_loop``): tw int32 [L, W]
    (this rank's word columns, sorted by length into NC chunks of W // NC
    columns, ``parallel.giant.rank_layout``), wcount int32 [W], hist int32
    [rows, v] (the global rows [base, base + rows) of the pair table),
    bounds int32 [rows] (upper bounds of those rows' maxima), presT int8
    [v, NC] (exact presence of each id in each chunk; only chunks below
    nc_used hold words).  Each merge, on every rank alike: the local
    lex-first pick through the bounds (a stale bound is refreshed from
    its row) as one int64 key (:func:`pick_key`, freq 0 below min_freq)
    that ``reduce_key`` reduces in place by MAX over the ranks -- one
    collective for the JAX loop's pmax/pmin/pmin, with the same (freq
    desc, row asc, col asc) tie-break; the merge over this rank's chunks
    that hold both ids, whose deltas dl ‖ dr (int32 [2v]) ``reduce_deltas``
    sums in place over the ranks; the table update of the own rows in
    ``apply_hist_updates`` order and the presence of the chunks that
    matched.  Both reduces None: a rank alone (world 1).  The scalars are
    those of :func:`giant_train_step`; merge step i creates id 256 +
    n_done + i.  Returns int32 [steps, 5] records (a, b, freq, did,
    n_refresh), where n_refresh counts this rank's row reads in the pick
    (0 after the first step that could not merge).

    CPU tensors run :func:`giant_sharded_train_plain`; CUDA tensors run
    ``csrc/giant_sharded.cu``: with no reduce, one persistent launch for
    all ``steps``; else per merge one cooperative launch (apply the
    previous merge, pick), ``reduce_key``, one launch (merge) and
    ``reduce_deltas`` on the current stream, then one launch that applies
    the last merge, 2 * steps + 1 in all; nothing waits for the device.
    Every launch counts."""
    L, W = tw.shape
    rows, v = hist.shape
    NC = presT.shape[1]
    if tw.dtype != torch.int32 or presT.dtype != torch.int8 or any(
            x.dtype != torch.int32 for x in (wcount, hist, bounds)):
        raise TypeError("tw, wcount, hist and bounds must be int32, presT "
                        "int8")
    if wcount.shape != (W,) or bounds.shape != (rows,) \
            or presT.shape[0] != v or W % NC or v > 65536 or v % 128 \
            or rows % 128 or not 0 <= base <= v - rows:
        raise ValueError(
            f"shape mismatch (v and rows multiples of 128, v <= 65536, "
            f"base + rows <= v): tw {tuple(tw.shape)}, wcount "
            f"{tuple(wcount.shape)}, hist {tuple(hist.shape)}, bounds "
            f"{tuple(bounds.shape)}, presT {tuple(presT.shape)}, base {base}")
    tensors = (tw, wcount, hist, bounds, presT)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("tw, wcount, hist, bounds and presT must be "
                         "contiguous")
    if L not in (16, 32, 64):
        raise ValueError(f"word rows L must be 16, 32 or 64, got {L}")
    if (W // NC) % 256:
        raise ValueError(f"chunk width {W // NC} must be a multiple of 256")
    if not 1 <= nc_used <= NC:
        raise ValueError(f"nc_used {nc_used} must be in [1, {NC}]")
    if 256 + n_done + min(steps, allowed) > v:
        raise ValueError("merge ids would exceed the table size v")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("tw, wcount, hist, bounds and presT must share one "
                         "device")
    kw = dict(base=base, reduce_key=reduce_key, reduce_deltas=reduce_deltas,
              unk=unk, min_freq=min_freq, n_done=n_done,
              init_done=init_done, allowed=allowed, nc_used=nc_used,
              steps=steps)
    if tw.device.type == "cpu":
        return giant_sharded_train_plain(*tensors, **kw)
    if tw.device.type != "cuda":
        raise ValueError(f"unsupported device {tw.device}")
    dev = tw.device
    i32 = dict(dtype=torch.int32, device=dev)
    d = torch.empty((2, 2 * v), **i32)       # two dl | dr buffers in turn
    # group keys, row-read keys, the pick's key
    keys = torch.empty(rows // 32 + 4, dtype=torch.int64, device=dev)
    scratch = torch.empty(NC + 10, **i32)    # chunk bits, slots, state
    records = torch.empty((steps, 5), **i32)
    k = lib()
    args = (tw.data_ptr(), wcount.data_ptr(), hist.data_ptr(),
            bounds.data_ptr(), presT.data_ptr(), d.data_ptr(),
            keys.data_ptr(), scratch.data_ptr(), records.data_ptr(), L, W,
            NC, nc_used, rows, v, base, steps, unk, min_freq, n_done,
            init_done, allowed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if reduce_key is None and reduce_deltas is None:
            _check(k.shred_giant_sharded_train(*args, stream))
            giant_sharded_train.launches += 1
            return records
        key = keys[-1:]
        for i in range(steps + 1):
            _check(k.shred_giant_sharded_apply_pick(*args, i, stream))
            giant_sharded_train.launches += 1
            if i == steps:
                break
            if reduce_key is not None:
                reduce_key(key)
            _check(k.shred_giant_sharded_merge(*args, i, stream))
            giant_sharded_train.launches += 1
            if reduce_deltas is not None:
                reduce_deltas(d[i & 1])
    return records


giant_sharded_train.launches = 0


def apply_row_shard(hist, bounds, base, a, b, new, dl, dr) -> None:
    """:func:`apply_hist_updates` on the own rows [base, base + rows) of
    the table, in place, then their bounds: a row outside {a, b, new}
    changes in cells (r, a) and (r, new) = dl[r], so its bound rises to
    dl[r] where that is larger; rows a, b and new take their exact
    maxima."""
    rows = hist.shape[0]
    dl_own = dl[base:base + rows]
    hist[:, a] -= dl_own
    hist[:, new] += dl_own
    for r, sign in ((b, -1), (new, 1)):
        if base <= r < base + rows:
            hist[r - base] += sign * dr
    if base <= a < base + rows:
        hist[a - base, b] = 0
    torch.maximum(bounds, dl_own, out=bounds)
    for r in {a, b, new}:
        if base <= r < base + rows:
            bounds[r - base] = hist[r - base].max()


def chunk_pass_plain(tw, wcount, presT, a, b, new, unk, v, nc_used):
    """:func:`merge_pass_plain` over the chunks c < nc_used of tw [L, W]
    (chunk c: the columns [c * cw, (c + 1) * cw), cw = W // NC) whose
    presence presT [v, NC] holds a and b, tw and presT in place: their
    columns are gathered, merged and scattered back, and the presence of
    a, b and new is rewritten in the chunks that matched, as the giant
    kernels rewrite it; returns (dl, dr)."""
    L, W = tw.shape
    cw = W // presT.shape[1]
    chunks = ((presT[a, :nc_used] != 0)
              & (presT[b, :nc_used] != 0)).nonzero()[:, 0]
    cols = (chunks[:, None] * cw
            + torch.arange(cw, device=tw.device)).reshape(-1)
    sub = tw[:, cols]
    t = sub.to(torch.int32)
    matched = ((t[:-1] == a) & (t[1:] == b)).any(0).view(-1, cw).any(1)
    dl, dr, _ = merge_pass_plain(sub, wcount[cols], a, b, new, unk, v)
    tw[:, cols] = sub
    per_chunk = sub.view(L, len(chunks), cw)
    hit = chunks[matched]
    presT[a, hit] = (per_chunk == a).any(2).any(0)[matched].to(torch.int8)
    presT[b, hit] = (per_chunk == b).any(2).any(0)[matched].to(torch.int8)
    presT[new, hit] = 1
    return dl, dr


def giant_sharded_train_plain(tw, wcount, hist, bounds, presT, *, base,
                              reduce_key=None, reduce_deltas=None, unk,
                              min_freq, n_done, init_done, allowed, nc_used,
                              steps) -> torch.Tensor:
    """Plain PyTorch version of :func:`giant_sharded_train`: per merge
    the lazy pick of the giant engine (:func:`_lazy_pick`) on the own
    rows, ``reduce_key``, :func:`chunk_pass_plain` on this rank's flagged
    chunks, ``reduce_deltas`` and :func:`apply_row_shard`."""
    v = hist.shape[1]
    dev = tw.device
    records = torch.zeros((steps, 5), dtype=torch.int32, device=dev)
    for i in range(steps):
        m, la, n_refresh = _lazy_pick(hist, bounds, min_freq)
        key = 0
        if m > 0:
            b = int((hist[la] == m).nonzero()[0, 0])  # smallest column
            key = pick_key(m, base + la, b)
        kt = torch.tensor([key], dtype=torch.int64, device=dev)
        if reduce_key is not None:
            reduce_key(kt)
        key = int(kt)
        m, a, b = key >> 32, 65535 - (key >> 16 & 0xFFFF), 65535 - (
            key & 0xFFFF)
        if not (m > 0 and not init_done and i < allowed):
            # nothing changes any more: no later step is merged
            records[i:, 2] = m
            records[i, 4] = n_refresh
            break
        new = 256 + n_done + i
        records[i] = torch.tensor([a, b, m, 1, n_refresh])
        dl, dr = chunk_pass_plain(tw, wcount, presT, a, b, new, unk, v,
                                  nc_used)
        d = torch.cat([dl, dr])
        if reduce_deltas is not None:
            reduce_deltas(d)
        apply_row_shard(hist, bounds, base, a, b, new, d[:v], d[v:])
    return records


# ---------------------------------------------------------------------
# the sparse merge loop (K5) and the sharded merge chain (K4)
# ---------------------------------------------------------------------

def _check_presence(tw, hist, presT) -> None:
    L, W = tw.shape
    v = hist.shape[0]
    if presT.dtype != torch.int8 or presT.shape != (v, W // CHUNK) \
            or W % CHUNK or not presT.is_contiguous():
        raise ValueError(f"presT must be contiguous int8 [v, W / {CHUNK}] "
                         f"with W a multiple of {CHUNK}: tw "
                         f"{tuple(tw.shape)}, presT {tuple(presT.shape)}")
    if presT.device != tw.device:
        raise ValueError("tw and presT must share one device")


def hist_sparse_train(tw: torch.Tensor, wcount: torch.Tensor,
                      hist: torch.Tensor, presT: torch.Tensor, *, unk: int,
                      min_freq: int, n_done: int, init_done: int,
                      allowed: int, steps: int,
                      rowmax: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`hist_fused_train` whose corpus pass reads only the
    CHUNK-column chunks whose presence holds both a and b; tw, hist and
    presT in place, the same records.

    Replaces the loop of ``shredword_tpu.ops.bpe_hist.make_train_loop_sparse``
    around ``_merge_kernel_sparse`` (``make_merge_step_sparse``).  presT
    int8 [v, NC], W = NC * CHUNK: 1 iff the id occurs in the chunk, exact
    (``bpe_hist.build_presence``; the JAX package keeps int32 [NC, 8, v]
    with 8 equal rows).  Every chunk that holds a and b gets the presence
    of a, b and new rewritten after the merge, as the TPU kernel does; the
    other chunks are not read.

    CPU tensors run :func:`hist_sparse_train_plain`; CUDA tensors run
    ``csrc/hist_step.cu``: one persistent launch for all ``steps``.  A
    given ``rowmax`` (int32 [2v] on the card) holds the rows' (max, arg)
    after the call."""
    kw = dict(n_done=n_done, allowed=allowed, steps=steps)
    _check_hist_args(tw, wcount, hist, **kw)
    _check_presence(tw, hist, presT)
    if tw.device.type == "cpu":
        records = hist_sparse_train_plain(tw, wcount, hist, presT, unk=unk,
                                          min_freq=min_freq,
                                          init_done=init_done, **kw)
        if rowmax is not None:
            rowmax.copy_(table_rowmax_plain(hist))
        return records
    L, W = tw.shape
    v = hist.shape[0]
    rowmax, d, records = _launch_scratch(v, steps, tw.device, rowmax)
    with torch.cuda.device(tw.device):
        stream = torch.cuda.current_stream(tw.device).cuda_stream
        rc = lib().shred_hist_sparse_train(
            tw.data_ptr(), wcount.data_ptr(), hist.data_ptr(),
            presT.data_ptr(), rowmax.data_ptr(), d[0].data_ptr(),
            d[1].data_ptr(), records.data_ptr(), L, W, v, W // CHUNK, steps,
            unk, min_freq, n_done, init_done, allowed, stream)
    _check(rc)
    hist_sparse_train.launches += 1
    return records


hist_sparse_train.launches = 0


def hist_sparse_train_plain(tw, wcount, hist, presT, *, unk, min_freq,
                            n_done, init_done, allowed,
                            steps) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_sparse_train`:
    :func:`sparse_pass_plain` inside :func:`merge_steps`."""
    v = hist.shape[0]
    return merge_steps(
        hist, lambda a, b, new: sparse_pass_plain(tw, wcount, presT, a, b,
                                                  new, unk, v)[:2],
        min_freq=min_freq, n_done=n_done, init_done=init_done,
        allowed=allowed, steps=steps)


def hist_sharded_train(tw: torch.Tensor, wcount: torch.Tensor,
                       hist: torch.Tensor, *, reduce=None, unk: int,
                       min_freq: int, n_done: int, init_done: int,
                       allowed: int, steps: int,
                       rowmax: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`hist_fused_train` on one rank's column block of the corpus
    with the replicated table: every merge's deltas dl ‖ dr (int32 [2v])
    go through ``reduce`` (in place, e.g. ``torch.distributed.all_reduce``
    over the ranks; None for a single rank) before the table update, so
    every rank keeps the same table and picks alike.  tw and hist in
    place, the same records.

    Replaces the loop of ``shredword_tpu.parallel.hist`` (and of
    ``shredword_tpu.ops.bpe_hist.make_train_loop``) around
    ``_merge_kernel`` (``make_merge_step``).

    CPU tensors run :func:`hist_sharded_train_plain`; CUDA tensors run
    ``csrc/hist_step.cu``'s chain: one launch that builds the rows'
    (max, arg), then per merge one cooperative launch and ``reduce`` on
    the current stream, then one launch that applies the last merge;
    nothing waits for the device.  Every launch counts.  A given
    ``rowmax`` holds the rows' (max, arg) after the call."""
    kw = dict(n_done=n_done, allowed=allowed, steps=steps)
    _check_hist_args(tw, wcount, hist, **kw)
    if tw.device.type == "cpu":
        records = hist_sharded_train_plain(tw, wcount, hist, reduce=reduce,
                                           unk=unk, min_freq=min_freq,
                                           init_done=init_done, **kw)
        if rowmax is not None:
            rowmax.copy_(table_rowmax_plain(hist))
        return records
    L, W = tw.shape
    v = hist.shape[0]
    rowmax, d, records = _launch_scratch(v, steps, tw.device, rowmax)
    state = torch.empty(8, dtype=torch.int32, device=tw.device)
    bufs = d.unbind(0)
    k = lib()
    with torch.cuda.device(tw.device):
        stream = torch.cuda.current_stream(tw.device).cuda_stream
        _check(k.shred_hist_chain_init(hist.data_ptr(), rowmax.data_ptr(),
                                       d.data_ptr(), state.data_ptr(), v,
                                       stream))
        hist_sharded_train.launches += 1
        head = (tw.data_ptr(), wcount.data_ptr(), hist.data_ptr(),
                rowmax.data_ptr(), d.data_ptr(), state.data_ptr(),
                records.data_ptr(), L, W, v)
        tail = (steps, unk, min_freq, n_done, init_done, allowed, stream)
        for i in range(steps + 1):
            _check(k.shred_hist_chain_step(*head, i, *tail))
            hist_sharded_train.launches += 1
            if reduce is not None and i < steps:
                reduce(bufs[i & 1])
    return records


hist_sharded_train.launches = 0


def hist_sharded_train_plain(tw, wcount, hist, *, reduce=None, unk,
                             min_freq, n_done, init_done, allowed,
                             steps) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_sharded_train`:
    :func:`merge_pass_plain` on this rank's columns, ``reduce`` of dl ‖ dr,
    inside :func:`merge_steps`."""
    v = hist.shape[0]

    def step(a, b, new):
        dl, dr, _ = merge_pass_plain(tw, wcount, a, b, new, unk, v)
        if reduce is None:
            return dl, dr
        d = torch.cat([dl, dr])
        reduce(d)
        return d[:v], d[v:]

    return merge_steps(hist, step, min_freq=min_freq, n_done=n_done,
                       init_done=init_done, allowed=allowed, steps=steps)


def sparse_pass_plain(tw, wcount, presT, a, b, new, unk, v):
    """:func:`merge_pass_plain` over only the chunks whose presence holds
    a and b: their columns are gathered, merged and scattered back, and
    their presence is rebuilt over every id, as the TPU kernel rebuilds
    it (bpe_hist.py:330-339); returns (dl, dr, nm)."""
    L = tw.shape[0]
    chunks = ((presT[a] != 0) & (presT[b] != 0)).nonzero()[:, 0]
    cols = (chunks[:, None] * CHUNK
            + torch.arange(CHUNK, device=tw.device)).reshape(-1)
    sub = tw[:, cols]
    dl, dr, nm = merge_pass_plain(sub, wcount[cols], a, b, new, unk, v)
    tw[:, cols] = sub
    t = sub.view(L, len(chunks), CHUNK).long()
    which = chunks.view(1, -1, 1).expand_as(t)
    ok = (t >= 0) & (t < v)
    presT[:, chunks] = 0
    presT[t[ok], which[ok]] = 1
    return dl, dr, nm


def _step_out(tw, pass_, scal, v) -> torch.Tensor:
    """int32 [2v + 1] = dl ‖ dr ‖ nm of ``pass_(a, b, new, unk)`` for scal
    = (a, b, new, unk, do); zeros when do == 0."""
    a, b, new, unk, do = scal.tolist()
    out = torch.zeros(2 * v + 1, dtype=torch.int32, device=tw.device)
    if do:
        dl, dr, nm = pass_(a, b, new, unk)
        out[:v], out[v:2 * v], out[2 * v] = dl, dr, nm
    return out


def hist_merge_step_plain(tw, wcount, scal, *, v) -> torch.Tensor:
    """One given merge over the corpus, tw in place: the plain form of
    ``shredword_tpu.ops.bpe_hist._merge_kernel`` (``make_merge_step``),
    the corpus pass of :func:`hist_sharded_train`.  scal int32 [5] =
    (a, b, new, unk, do); do == 0 changes nothing, as the JAX loop's
    ``lax.cond`` skips the step.  Returns int32 [2v + 1] = dl ‖ dr ‖ nm:
    the left and right neighbour weights of the merged occurrences and
    their number."""
    return _step_out(tw, lambda a, b, new, unk: merge_pass_plain(
        tw, wcount, a, b, new, unk, v), scal, v)


def hist_merge_step_sparse_plain(tw, wcount, presT, scal, *,
                                 v) -> torch.Tensor:
    """:func:`hist_merge_step_plain` over only the chunks whose presence
    holds a and b, tw and presT in place: the plain form of
    ``_merge_kernel_sparse`` (``make_merge_step_sparse``), the corpus pass
    of :func:`hist_sparse_train`."""
    return _step_out(tw, lambda a, b, new, unk: sparse_pass_plain(
        tw, wcount, presT, a, b, new, unk, v), scal, v)


# ---------------------------------------------------------------------
# the flat engine's merge loop (F1)
# ---------------------------------------------------------------------

FLAT_MAX_BLOCKS = 1024     # block results the wrapper makes room for
FLAT_ST_OVERFLOW, FLAT_ST_MERGED, FLAT_ST_STEPS, FLAT_ST_DONE, \
    FLAT_ST_VISITED, FLAT_ST_CANDIDATES, FLAT_ST_REFRESHED, \
    FLAT_ST_LISTED, FLAT_ST_HALT, FLAT_ST_USED, FLAT_ST_ADDED, \
    FLAT_ST_TICKET = range(12)          # csrc/flat_table.cuh's st[]
FLAT_HALT_FALLBACK = 1                  # csrc/flat_table.cuh HALT_FALLBACK


def flat_train(ts: bpe_ops.TrainState, unk_id: int, min_pair_freq: int, *,
               target_merges: int, max_steps: int) -> bpe_ops.TrainState:
    """Up to ``max_steps`` greedy merges of the flat engine, from merge
    ``ts.n_merges`` to ``target_merges``: merge k creates id 256 + k, is
    the highest-count pair that reaches ``min_pair_freq`` (pairs holding
    ``unk_id`` are never counted), ties to the smallest (a, b), and
    ``done`` is set when no pair reaches it.  Returns the advanced
    ``ts``, its ``merges`` / ``merge_freqs`` filled in place.

    Replaces ``shredword_tpu.ops.bpe_ops.train_loop`` (a ``lax.while_loop``
    of ``best_pair`` and ``apply_merge``).  A corpus on the CPU runs
    :func:`flat_train_plain` (``bpe_ops.train_loop``).  On a CUDA device
    the first call makes ``ts.corpus`` a ``bpe_ops.FlatState`` (its tokens
    are then merged in place; ``bpe_ops.final_corpus`` gives the plain
    arrays) and every call that has a merge to make is one launch of
    ``csrc/flat.cu``: the first counts the stream's pairs, then each
    merge picks, records and merges the words of the chunks that hold
    both ids with the table's exact deltas, all in the launch; the
    records, the merges made and ``done`` come back in one copy after it
    (``FlatState.visited``, ``.candidates`` and ``.refreshed`` count the
    chunks the passes visited, the words there whose signature holds the
    pair and the segment maxima the picks recomputed).  A call
    after ``done`` or at ``target_merges`` changes nothing and launches
    nothing."""
    dev = _flat_device(ts)
    if dev.type == "cpu":
        return flat_train_plain(ts, unk_id, min_pair_freq,
                                target_merges=target_merges,
                                max_steps=max_steps)
    ts, launched = _flat_call(ts, unk_id, min_pair_freq,
                              target_merges=target_merges,
                              max_steps=max_steps)
    flat_train.launches += launched
    return ts


flat_train.launches = 0

# The plain version of flat_train: the flat engine's per-merge loop in
# PyTorch ops (recount, argmax, select, compact).
flat_train_plain = bpe_ops.train_loop


def _flat_device(ts: bpe_ops.TrainState) -> torch.device:
    """The device of a flat TrainState: a CPU one holds the plain
    version's arrays, a CUDA one either."""
    dev = ts.corpus.tokens.device
    if dev.type == "cpu" and isinstance(ts.corpus, bpe_ops.FlatState):
        raise ValueError("F1's FlatState runs on a CUDA device only")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _flat_steps(ts: bpe_ops.TrainState, target_merges: int,
                max_steps: int) -> int:
    """The merges a call makes at most (0 after done or at the target)."""
    n = ts.n_merges
    steps = min(max_steps, target_merges - n)
    if ts.done or steps <= 0:
        return 0
    if n + steps > len(ts.merges) or 256 + n + steps > 2**31 - 1:
        raise ValueError(f"merges {n}..{n + steps} exceed the records "
                         f"({len(ts.merges)}) or the int32 ids")
    return steps


def _flat_args(fs: bpe_ops.FlatState, bbest: torch.Tensor,
               records: torch.Tensor) -> list[int]:
    """The pointers of F1's state, in the C interface's order."""
    return [x.data_ptr() for x in (
        fs.tokens, fs.off, fs.len, fs.wcnt, fs.pres, fs.sig, fs.tkey,
        fs.cnt, fs.skey, fs.sce, fs.dirty, fs.st, bbest, records)]


def _flat_finish(ts, fs, st, rec, n: int, k: int, done: bool):
    """ts after a call that made merges n .. n + k (records rec), with
    F1's counters from its state st (int32 [8] on the host)."""
    if st[FLAT_ST_OVERFLOW]:
        raise RuntimeError("F1's pair table is full: its counts are no "
                           "longer exact")
    ts.merges[n:n + k] = rec[:k, :2]
    ts.merge_freqs[n:n + k] = rec[:k, 2]
    fs.merged = int(st[FLAT_ST_MERGED])
    fs.visited = int(st[FLAT_ST_VISITED])
    fs.refreshed = int(st[FLAT_ST_REFRESHED])
    fs.candidates = int(st[FLAT_ST_CANDIDATES])
    return ts._replace(corpus=fs, n_merges=n + k, done=done)


def _flat_call(ts, unk_id, min_pair_freq, *, target_merges, max_steps):
    """One call of F1 on a CUDA device: (the advanced ts, the launches
    made: 1, or 0 when it had no merge to make)."""
    dev = ts.corpus.tokens.device
    fs = (ts.corpus if isinstance(ts.corpus, bpe_ops.FlatState)
          else bpe_ops.FlatState(ts.corpus))
    ts = ts._replace(corpus=fs)
    n = ts.n_merges
    steps = _flat_steps(ts, target_merges, max_steps)
    if not steps:
        return ts, 0
    fs.reserve(256 + target_merges)      # a row for every new id
    records = torch.empty((steps, 3), dtype=torch.int32, device=dev)
    bbest = torch.empty(2 * FLAT_MAX_BLOCKS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().shred_flat_train(
            *_flat_args(fs, bbest, records), fs.n_words, fs.pres.shape[1],
            fs.cap, steps, unk_id, min(min_pair_freq, 2**31 - 1), n,
            int(not fs.counted), FLAT_MAX_BLOCKS, stream)
    _check(rc)
    fs.counted = True
    out = torch.cat([fs.st, records.view(-1)]).cpu().numpy()
    w = bpe_ops.ST_WORDS
    st, rec = out[:w], out[w:].reshape(steps, 3)
    return _flat_finish(ts, fs, st, rec, n, int(st[FLAT_ST_STEPS]),
                        bool(st[FLAT_ST_DONE])), 1


# ---------------------------------------------------------------------
# the sharded flat engine's merge loop (S1)
# ---------------------------------------------------------------------

S1_ROWS = 4096    # the rows a rank's list takes in an exchange, at first


def flat_sharded_train(ts: bpe_ops.TrainState, unk_id: int,
                       min_pair_freq: int, *, target_merges: int,
                       max_steps: int, group=None,
                       rows: int | None = None) -> bpe_ops.TrainState:
    """:func:`flat_train` over the ranks of a torch.distributed ``group``,
    each holding its own span of the stream (words never span ranks):
    every rank makes the same merges, those of the whole corpus, with the
    same tie-break, and returns the same records; ``ts.corpus`` is this
    rank's span.  Called by every rank of the group alike.

    Replaces the per-merge body of ``shredword_tpu.parallel.train``
    (``shard_body`` of ``build_sharded_train_loop``).  CPU tensors run
    :func:`flat_sharded_train_plain`; CUDA tensors run S1:

      - no group or a rank alone (world 1): F1's call (:func:`flat_train`
        on the span, ``csrc/flat.cu``), one persistent launch a call, no
        collective;
      - world > 1: the chain of ``csrc/flat_sharded.cu``.  The first call
        makes ``ts.corpus`` a ``bpe_ops.FlatState`` whose table is sized
        on the whole stream and is to hold the whole corpus's pair
        counts: the ranks' pair counts (``bpe_ops.pair_counts`` of the
        span, once), gathered (``parallel.train.gather_pairs``) and summed
        by key, are its first rows.  Then per merge launch A (add every
        rank's gathered rows to the table, the pick, the record), launch M
        (F1's pass over the span, its net deltas summed by key in a delta
        table on the card, compacted into the rank's list) and
        ``parallel.train.exchange_rows``: every rank's list at a fixed
        size of ``FlatState.rows`` rows (``rows`` when the run starts,
        else :data:`S1_ROWS`), which the next launch A reads.  Two
        launches a merge a call plans, and no read on the host between
        them: the records, the state and the gathered headers come back
        once a call.  A merge that finds no pair is the last; the
        launches after it in the call do nothing.  When a list was longer
        than the rows, launch A halts the chain on every rank alike (the
        launches after it do nothing), and at the call's end every rank
        exchanges again with the rows grown (``parallel.train.next_rows``;
        never shrunk in a run), notes the merge in
        ``FlatState.fallbacks`` and runs the call's remaining merges with
        two launches each.  A rank's overflow travels in its header, so
        every rank raises the same ``RuntimeError``.

    A call after ``done`` or at ``target_merges`` changes nothing and
    launches nothing.  Every launch counts.  A build or launch failure
    raises; nothing falls back to the plain version."""
    dev = _flat_device(ts)
    kw = dict(target_merges=target_merges, max_steps=max_steps)
    if dev.type == "cpu":
        return flat_sharded_train_plain(ts, unk_id, min_pair_freq,
                                        group=group, **kw)
    if group is None or group.size() == 1:
        ts, launched = _flat_call(ts, unk_id, min_pair_freq, **kw)
        flat_sharded_train.launches += launched
        return ts
    from ..parallel import train as par_train   # the chain's collectives

    n = ts.n_merges
    steps = _flat_steps(ts, target_merges, max_steps)
    if not steps:
        return ts
    fs = ts.corpus
    if not isinstance(fs, bpe_ops.FlatState):
        n_all, first = par_train.initial_deltas(fs, unk_id, group)
        fs = bpe_ops.FlatState(fs, table_n=n_all)
        fs.counted = True
        fs.recv = par_train.pack_rows(first)[None]     # one list: the start
    fs.reserve(256 + target_merges)
    _s1_room(fs, rows)
    i32 = dict(dtype=torch.int32, device=dev)
    records = torch.empty((steps, 3), **i32)
    bbest = torch.empty(2 * FLAT_MAX_BLOCKS, dtype=torch.int64, device=dev)
    ptrs = _flat_args(fs, bbest, records) + [
        x.data_ptr() for x in (fs.dkey, fs.dval, fs.dused, fs.send)]
    minf = min(min_pair_freq, 2**31 - 1)
    fs.st[FLAT_ST_STEPS] = 0
    w, k = bpe_ops.ST_WORDS, 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        while True:
            for i in range(k, steps):
                for phase in (0, 1):            # launch A, then launch M
                    _check(lib().shred_flat_sharded_step(
                        *ptrs, fs.recv.data_ptr(), fs.n_words,
                        fs.pres.shape[1], fs.cap, len(fs.dkey),
                        len(fs.send) - 1, steps, unk_id, minf, n,
                        fs.recv.shape[0], fs.recv.shape[1] - 1, i, phase,
                        FLAT_MAX_BLOCKS, stream))
                    flat_sharded_train.launches += 1
                fs.recv = par_train.exchange_rows(fs.send, fs.rows, group,
                                                  out=fs.recv)
                fs.exchanged += fs.recv.shape[0] * fs.recv.shape[1]
            out = torch.cat([fs.st.long(), records.view(-1).long(),
                             fs.recv[:, 0].reshape(-1)]).cpu().numpy()
            st, rec = out[:w], out[w:w + 3 * steps].reshape(steps, 3)
            # an overflow flag raises here, on every rank alike
            grown = par_train.next_rows(out[w + 3 * steps:].reshape(-1, 2),
                                        fs.rows)
            k = int(st[FLAT_ST_STEPS])
            if st[FLAT_ST_HALT] != FLAT_HALT_FALLBACK:
                break
            fs.fallbacks.append(n + k)
            fs.rows = grown
            fs.recv = par_train.exchange_rows(fs.send, fs.rows, group)
            fs.exchanged += fs.recv.shape[0] * fs.recv.shape[1]
            fs.st[FLAT_ST_HALT] = 0
    fs.listed, fs.added = int(st[FLAT_ST_LISTED]), int(st[FLAT_ST_ADDED])
    return _flat_finish(ts, fs, st, rec, n, k, bool(st[FLAT_ST_DONE]))


flat_sharded_train.launches = 0


def _s1_room(fs: bpe_ops.FlatState, rows: int | None) -> None:
    """S1's buffers on a rank above world 1, the same shapes on every
    rank: the delta table, a power of two of at least twice the most
    distinct pairs a merge can change (at most 2N of the whole stream,
    and at most four an id, every changed pair holding a, b or the new
    id beside one other id), with its used slots; the compact list, with
    room for half the table; and, at the run's start, the rows of the
    exchange: ``rows``, else :data:`S1_ROWS`, at most the list's room."""
    most = min(2 * fs.table_n, 4 * fs.pres.shape[0] + 4)
    dcap = 1 << max(10, (2 * most - 1).bit_length())
    dev = fs.tokens.device
    if fs.dkey is None or len(fs.dkey) < dcap:
        fs.dkey = torch.full((dcap,), -1, dtype=torch.int64, device=dev)
        fs.dval = torch.zeros(dcap, dtype=torch.int32, device=dev)
        fs.dused = torch.empty(dcap, dtype=torch.int32, device=dev)
        fs.send = torch.zeros((1 + dcap // 2, 2), dtype=torch.int64,
                              device=dev)
    if fs.rows is None:
        fs.rows = min(S1_ROWS if rows is None else rows, dcap // 2)


def flat_sharded_train_plain(ts, unk_id, min_pair_freq, *, target_merges,
                             max_steps, group=None) -> bpe_ops.TrainState:
    """Plain PyTorch version of :func:`flat_sharded_train`:
    ``bpe_ops.train_loop`` on the span, each merge picked by
    ``parallel.train.global_best_pair`` over ``group`` (every rank's
    pairs counted again, gathered and summed by key) when it has more
    than one rank.  The plain version of the chain's exchange, its
    headers and its fallback is ``parallel.train.exchange_deltas``."""
    pick = bpe_ops.best_pair
    if group is not None and group.size() > 1:
        from ..parallel.train import global_best_pair

        pick = functools.partial(global_best_pair, group=group)
    return bpe_ops.train_loop(ts, unk_id, min_pair_freq,
                              target_merges=target_merges,
                              max_steps=max_steps, pick=pick)
