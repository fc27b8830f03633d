"""Benchmark of the PyTorch port: BPE training MB/s on one CUDA device
against the reference trainer's algorithm on the host.

    python -m shredword_tpu_torch.bench [--device cuda] [--corpus PATH]
        [--raw-mb 16] [--no-side]

The port's counterpart of the JAX package's ``bench.py``, with its
configuration and its output: the last line of standard output is ONE
JSON object, ``{"metric": "train_mb_s", "value", "unit": "MB/s",
"vs_baseline"}``, and everything else goes to standard error.

Metric: raw corpus bytes over the wall time of ``BPETrainer.train()``
(the merge phase; the host clock starts after ``load_corpus`` and is
read after ``torch.cuda.synchronize`` on both ends), the best of 3 runs
after one warm-up, on the 16 MB zipf corpus of :func:`make_corpus` at
vocab 768, min_pair_freq 50, coverage 0.9999, unk -1.  Baseline: the
port's native faithful engine (``runtime.native.FaithfulTrainer``: the
reference trainer's algorithm and tie-breaks, in the port's own C++) on
the same corpus and config on this host's CPU.

Before the line is printed the hist, giant and flat engines train the
same config on the device and must save identical bytes, and (unless
``--no-side``) the side metrics of ``bench.py`` run, each after a
warm-up, and report on standard error.  Any failure raises: the process
exits non-zero and prints no JSON line.  It runs on the card unless
``--device cpu`` is given (the kernels' plain versions, for the tests);
with no card it stops with ``ConfigError``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import resolve_device

VOCAB = 768
MIN_FREQ = 50
COVERAGE = 0.9999
RAW_MB = 16
SEED = 1234
WARMUP = 1          # untimed headline runs first (the first builds K1)
RUNS = 3            # timed headline runs after the warm-up; the best counts
# the bytes make_corpus(path) writes at RAW_MB and SEED
CORPUS_BYTES = 16_153_229
CORPUS_SHA256 = ("0d4249769060f86272db067c48fda469"
                 "c47e0d4eb4114d3ad37e2c62beb58dfc")
# the bytes make_long_corpus(path) writes at RAW_MB and SEED
LONG_CORPUS_BYTES = 16_015_003
LONG_CORPUS_SHA256 = ("acc12ae8d14a198d935cd40514555bcf"
                      "7d2ee79db29453be08cd8bf4610825b7")
GIANT_VOCAB = 32768
# BASELINE config 2: BPETrainer(GIANT_VOCAB, **BIG) with the other
# arguments at their defaults (unk_id 0), on make_big_corpus at BIG_RAW_MB
BIG = dict(unk_id=0, character_coverage=1.0, min_pair_freq=2000)
BIG_RAW_MB = 1000
BIG_SEED = 99
BIG_RUNS = 3        # timed config 2 runs; the best counts
# the bytes make_big_corpus(path) writes at BIG_RAW_MB and BIG_SEED
BIG_CORPUS_BYTES = 1_008_579_866
BIG_CORPUS_SHA256 = ("7c622e6e39f9bb77742001746e97857b"
                     "9a6c25ab22fe2788f0eab35a90c6ffed")
ENGINES = ("hist", "giant", "flat")     # the cross-check's
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BenchError(RuntimeError):
    """A check of the bench failed: its result cannot be trusted."""


def bench_dir() -> str:
    """The bench's own directory under the temp dir (its default
    corpora), apart from the JAX bench's."""
    return os.path.join(tempfile.gettempdir(), "shredword_tpu_torch_bench")


def default_corpus(raw_mb: float = RAW_MB) -> str:
    name = "corpus.txt" if raw_mb == RAW_MB else f"corpus_{raw_mb:g}mb.txt"
    return os.path.join(bench_dir(), name)


def make_corpus(path: str, raw_mb: float = RAW_MB,
                seed: int = SEED) -> None:
    """Deterministic zipf-ish corpus: ~100k distinct words, raw_mb MB.
    The JAX bench's generator (``bench.make_corpus``), byte for byte;
    it always writes the file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rng = np.random.RandomState(seed)
    n_vocab = 100_000
    # synthetic word shapes: letter bigram chains, lengths 2..14
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.randint(2, 15, n_vocab)
    words = ["".join(letters[rng.randint(0, 26, L)]) for L in lens]
    ranks = np.arange(1, n_vocab + 1)
    probs = 1.0 / ranks ** 1.05
    probs /= probs.sum()
    target = raw_mb * 10**6
    with open(path, "w") as f:
        written = 0
        while written < target:
            idx = rng.choice(n_vocab, size=20_000, p=probs)
            chunk_words = [words[i] for i in idx]
            line_len = 0
            parts = []
            for w in chunk_words:
                parts.append(w)
                line_len += len(w) + 1
                if line_len > 80:
                    parts.append("\n")
                    line_len = 0
                else:
                    parts.append(" ")
            s = "".join(parts)
            f.write(s)
            written += len(s)


def make_long_corpus(path: str, raw_mb: float = RAW_MB,
                     seed: int = SEED) -> None:
    """Deterministic corpus of long words: CJK text split at its
    punctuation, so each clause is one word of the loader.  100,000
    clause shapes of 2-40 characters (uniform), each character drawn
    zipf(1.05) over the 3,500 code points from U+4E00 (3 bytes each in
    UTF-8), so about half the clauses are over 64 bytes; clauses drawn
    zipf(1.05) over the shapes as :func:`make_corpus` draws its words
    (1,000 a draw, so a small raw_mb stays small), one space between
    them and a newline past 80 characters, until raw_mb MB of UTF-8.
    It always writes the file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rng = np.random.RandomState(seed)
    n_shapes, n_chars = 100_000, 3_500
    lens = rng.randint(2, 41, n_shapes)
    p_char = 1.0 / np.arange(1, n_chars + 1) ** 1.05
    chars = rng.choice(n_chars, size=int(lens.sum()),
                       p=p_char / p_char.sum())
    cps = np.split(0x4E00 + chars, np.cumsum(lens)[:-1])
    shapes = ["".join(map(chr, c)) for c in cps]
    probs = 1.0 / np.arange(1, n_shapes + 1) ** 1.05
    probs /= probs.sum()
    target = raw_mb * 10**6
    with open(path, "w", encoding="utf-8") as f:
        written = 0
        while written < target:
            parts, line_len = [], 0
            for i in rng.choice(n_shapes, size=1_000, p=probs):
                parts.append(shapes[i])
                line_len += len(shapes[i]) + 1
                if line_len > 80:
                    parts.append("\n")
                    line_len = 0
                else:
                    parts.append(" ")
            s = "".join(parts)
            f.write(s)
            written += len(s.encode("utf-8"))


def make_big_corpus(path: str, raw_mb: int = BIG_RAW_MB,
                    seed: int = BIG_SEED) -> None:
    """Deterministic Heaps-law corpus of raw_mb MB, the corpus of
    BASELINE config 2 at 1,000 MB: a pool of 6 * (raw_mb * 1e6)^0.65
    a-z words (Heaps' law; lognormal lengths 2..14, the shortest first,
    words of 4 letters and more ending in a letter pair unique to their
    rank), drawn zipf(1.0) over the pool in blocks of 4,000,000 words,
    one space between them and a newline after every 16th.  The
    generator of ``tests/golden/bigcorpus_gen.py`` byte for byte; the
    blocks' draws are taken in order and their bytes built on a thread
    per core.  It always writes the file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    target = raw_mb * 10 ** 6
    rng = np.random.RandomState(seed)
    n_vocab = max(1000, int(6.0 * target ** 0.65))
    lens = np.rint(rng.lognormal(1.75, 0.40, n_vocab)).astype(np.int64)
    np.clip(lens, 2, 14, out=lens)
    lens.sort()                     # rank 0 = shortest = most frequent
    pool_off = np.zeros(n_vocab + 1, np.int64)
    np.cumsum(lens, out=pool_off[1:])
    pool = rng.randint(97, 123, pool_off[-1]).astype(np.uint8)  # a-z
    li = np.nonzero(lens >= 4)[0]
    pool[pool_off[li + 1] - 2] = 97 + (li % 26).astype(np.uint8)
    pool[pool_off[li + 1] - 1] = 97 + ((li // 26) % 26).astype(np.uint8)
    probs = 1.0 / np.arange(1, n_vocab + 1) ** 1.0
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    n = 4_000_000                   # words per block
    newline_every = 16              # words per line

    def block(draws: np.ndarray) -> bytes:
        idx = np.searchsorted(cdf, draws)
        np.clip(idx, 0, n_vocab - 1, out=idx)
        wl = lens[idx]
        out_off = np.zeros(n + 1, np.int64)
        np.cumsum(wl + 1, out=out_off[1:])      # +1 separator per word
        out = np.full(out_off[-1], 32, np.uint8)
        out[out_off[1:][newline_every - 1::newline_every] - 1] = 10
        # letter j of word i: pool[pool_off[idx[i]] + j] to out_off[i] + j
        at = np.arange(int(wl.sum()), dtype=np.int64) \
            - np.repeat(out_off[:-1] - np.arange(n), wl)
        out[np.repeat(out_off[:-1], wl) + at] = \
            pool[np.repeat(pool_off[idx], wl) + at]
        return out.tobytes()

    # expected bytes of a block: ahead of the writes, only the blocks
    # the target still needs are drawn and built
    per_block = n * (float(probs @ lens) + 1)
    workers = os.cpu_count() or 1
    written, pending = 0, collections.deque()
    with ThreadPoolExecutor(workers) as ex, open(path, "wb") as f:
        while written < target:
            while not pending or (len(pending) < workers and written
                                  + len(pending) * per_block < target):
                pending.append(ex.submit(block, rng.random_sample(n)))
            out = pending.popleft().result()
            f.write(out)
            written += len(out)
        for p in pending:           # drawn ahead, not needed
            if not p.cancel():
                p.result()


def big_corpus_path() -> str:
    return os.path.join(bench_dir(), f"big_{BIG_RAW_MB}mb.txt")


def ensure_big_corpus(path: str | None = None) -> tuple[str, bool]:
    """The 1 GB corpus of BASELINE config 2 at ``path`` (default
    :func:`big_corpus_path`), reused when the file there has its known
    size and digest and written otherwise, as :func:`ensure_corpus`
    does (an existing other file outside :func:`bench_dir` is refused).
    Returns (path, whether the file was reused)."""
    path = path or big_corpus_path()
    if (os.path.isfile(path) and os.path.getsize(path) == BIG_CORPUS_BYTES
            and _sha256(path) == BIG_CORPUS_SHA256):
        return path, True
    if os.path.lexists(path) and not _inside(path, bench_dir()):
        raise BenchError(f"{path} exists and is not the {BIG_RAW_MB} MB "
                         "corpus; not overwriting it (pass a path that "
                         "does not exist yet)")
    make_big_corpus(path, BIG_RAW_MB, BIG_SEED)
    return path, False


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


def _inside(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def ensure_corpus(path: str, raw_mb: float = RAW_MB) -> bool:
    """Write the bench corpus at ``path`` unless the file there already
    is it: only the RAW_MB corpus has a known digest, so a file is
    reused only when it is that size and digest (a file of about the
    right size is not enough).  Any other existing file is overwritten
    only inside :func:`bench_dir`; elsewhere it raises BenchError and
    leaves the file alone.  Returns whether the file was reused."""
    if (raw_mb == RAW_MB and os.path.isfile(path)
            and os.path.getsize(path) == CORPUS_BYTES
            and _sha256(path) == CORPUS_SHA256):
        return True
    if os.path.lexists(path) and not _inside(path, bench_dir()):
        raise BenchError(f"{path} exists and is not the {raw_mb:g} MB bench "
                         "corpus; not overwriting it (pass a path that does "
                         "not exist yet)")
    make_corpus(path, raw_mb)
    return False


def _say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> dict:
    """The launch counters of the kernels on the bench's path."""
    from .ops import _kernels, encode_ops, unigram_ops

    return {"K1": _kernels.hist_fused_train, "K3": _kernels.giant_train_step,
            "F1": _kernels.flat_train, "E1": encode_ops.encode_core,
            "U1": unigram_ops.fb_core, "U2": unigram_ops.viterbi_core}


@contextlib.contextmanager
def launches(device: torch.device, *names: str):
    """Counts the launches of the named kernels inside the block into
    the dict it yields; on a CUDA device each must have launched (the
    wrappers raise rather than fall back, so a count of 0 means the path
    went elsewhere).  On the CPU the plain versions run and count
    nothing."""
    fns = _counters()
    before = {k: fns[k].launches for k in names}
    got: dict[str, int] = {}
    yield got
    got.update({k: fns[k].launches - before[k] for k in names})
    if device.type == "cuda":
        missing = [k for k in names if got[k] == 0]
        if missing:
            raise BenchError(f"{', '.join(missing)} never launched on "
                             f"{device}")


def _launch_note(got: dict) -> str:
    return ", ".join(f"{k} {n}" for k, n in got.items()) + " launches"


# ---------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------

def measure_faithful(corpus: str) -> tuple[float, int]:
    """The port's native faithful engine (the reference's algorithm and
    tie-breaks): train seconds and merges."""
    from .runtime.native import FaithfulTrainer, NativeCorpus

    c = NativeCorpus.from_file(corpus, faithful_order=True)
    t = FaithfulTrainer(VOCAB, -1, COVERAGE, MIN_FREQ)
    try:
        t.load(c)
        t0 = time.perf_counter()
        n = t.train()
        dt = time.perf_counter() - t0
    finally:
        t.free()
        c.free()
    return dt, n


def measure_baseline(corpus: str) -> tuple[str, float, int]:
    """(kind, train seconds, merges) of the baseline on this host."""
    dt, n = measure_faithful(corpus)
    kind = "native faithful engine (runtime.native.FaithfulTrainer)"
    _say(f"baseline: {kind}: {dt:.6f} s, {n} merges")
    return kind, dt, n


# ---------------------------------------------------------------------
# headline and cross-check
# ---------------------------------------------------------------------

def train_once(corpus: str, device, *, engine: str = "auto",
               vocab: int = VOCAB, save_to: str | None = None,
               **cfg) -> tuple[float, int]:
    """One BPETrainer load_corpus -> train (timed) -> optional save:
    (train seconds, merges).  The clock starts after load_corpus and a
    synchronise, and stops after a synchronise."""
    from .models.bpe import BPETrainer

    dev = torch.device(device)
    kw = dict(unk_id=-1, character_coverage=COVERAGE,
              min_pair_freq=MIN_FREQ)
    kw.update(cfg)
    t = BPETrainer(target_vocab_size=vocab, backend="cuda", device=dev,
                   engine=engine, **kw)
    try:
        t.load_corpus(corpus)
        _sync(dev)
        t0 = time.perf_counter()
        n = t.train()
        _sync(dev)
        dt = time.perf_counter() - t0
        if save_to is not None:
            t.save(save_to + ".model", save_to + ".vocab")
    finally:
        t.destroy()
    return dt, n


def measure_train(corpus: str, device="cuda", save_to: str | None = None
                  ) -> tuple[float, int, list[float]]:
    """The headline: BPETrainer(768, unk -1, coverage 0.9999,
    min_pair_freq 50, backend "cuda") on ``device`` (auto -> hist -> K1,
    one persistent launch per call), ``WARMUP`` untimed runs, then
    ``RUNS`` timed runs.  Returns (best seconds, merges, every run's seconds);
    the last run saves to ``save_to``.model/.vocab when given."""
    dev = resolve_device(device)
    with launches(dev, "K1") as got:
        for _ in range(WARMUP):
            train_once(corpus, dev)
        times = []
        for i in range(RUNS):
            dt, n = train_once(corpus, dev, save_to=(
                save_to if i == RUNS - 1 else None))
            times.append(dt)
    _say(f"train vocab {VOCAB} on {dev}: {n} merges; runs "
         + " ".join(f"{s:.6f}" for s in times)
         + f" s; median {statistics.median(times):.6f} s, best "
         f"{min(times):.6f} s, spread (max/min) "
         f"{max(times) / min(times):.4f}; {_launch_note(got)}")
    return min(times), n, times


def read_model(prefix: str) -> tuple[bytes, bytes]:
    with open(prefix + ".model", "rb") as f, \
            open(prefix + ".vocab", "rb") as g:
        return f.read(), g.read()


def check_device_engines(corpus: str, device, work: str) -> dict:
    """Cross-check: the hist (K1), giant (K3) and flat (F1) engines
    are three independent device counting paths that must save
    bit-identical models at the headline config.  Raises BenchError if
    they disagree.  Returns each engine's (.model, .vocab) bytes."""
    dev = resolve_device(device)
    outs = {}
    with launches(dev, "K1", "K3", "F1") as got:
        for eng in ENGINES:
            prefix = os.path.join(work, f"check_{eng}")
            train_once(corpus, dev, engine=eng, save_to=prefix)
            outs[eng] = read_model(prefix)
    if not outs["hist"] == outs["giant"] == outs["flat"]:
        raise BenchError("device engine cross-check FAILED: the engines "
                         "disagree; the measured result cannot be trusted")
    _say(f"device engine cross-check: hist == giant == flat (model+vocab "
         f"bit-identical); {_launch_note(got)}")
    return outs


# ---------------------------------------------------------------------
# side metrics (standard error only)
# ---------------------------------------------------------------------

def _best_s(fn, trials: int = 3) -> float:
    """Best host seconds of ``trials`` calls (each returns host data)."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _read_text(corpus: str, chars: int) -> str:
    with open(corpus) as f:
        return f.read(chars)


def measure_presplit(corpus: str) -> dict:
    """GPT-pattern pre-split MB/s on 8 MB: the native scanner against
    the regex module, with the same parity check."""
    from . import pretokenize

    text = _read_text(corpus, 8 * 10**6)
    data = text.encode()
    mb = len(data) / 1e6
    pretokenize.gpt_starts_bytes(data[:1000])     # class table warm-up
    t_native = _best_s(lambda: pretokenize.gpt_starts_bytes(data))
    starts = pretokenize.gpt_starts_bytes(data)
    t0 = time.perf_counter()
    want = pretokenize._compiled(pretokenize.PATTERN_GPT).findall(text)
    t_regex = time.perf_counter() - t0
    if len(want) != len(starts):
        raise BenchError("pre-split parity failure: the native scanner "
                         "and the regex module disagree")
    return {"native": mb / t_native, "regex": mb / t_regex,
            "x": t_regex / t_native, "chunks": len(starts)}


def _device_ms(fn, device: torch.device, reps: int) -> float:
    """ms per call of fn over ``reps`` back-to-back calls: CUDA events
    on a card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def encode_launch_ms(df, dl, table, v: int, device: torch.device,
                     reps: int = 20) -> tuple[float, float, float]:
    """Device ms per call of csrc/encode.cu's two launches (merge, then
    pack) on the chunks of lengths dl over the bytes df, both on the
    card, and of each launch alone: ``reps`` back-to-back calls between
    two CUDA events, launched through the library directly (uncounted).
    One encode_core call prepares the offsets, buffers and the ids' ends
    beforehand, so no cumsum and no host readback falls in the window."""
    from .ops import _kernels, encode_ops

    ids, counts = encode_ops.encode_core(df, dl, table, v=v)
    start = torch.cumsum(dl, 0, dtype=torch.int64) - dl
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    tok = torch.empty_like(df, dtype=torch.int32)
    rk = torch.empty_like(df, dtype=torch.int32)
    if isinstance(table, encode_ops.MergeTable):
        targs = (None, table.ka.data_ptr(), table.kb.data_ptr(),
                 table.rank.data_ptr(), v, table.capacity, table.max_probe)
    else:
        targs = (table.data_ptr(), None, None, None, v, 0, 0)
    k = _kernels.lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    W = dl.shape[0]

    def call(merge=True, pack=True):
        if merge:
            _kernels._check(k.shred_encode_chunks(
                df.data_ptr(), start.data_ptr(), dl.data_ptr(), W, *targs,
                tok.data_ptr(), rk.data_ptr(), counts.data_ptr(), None,
                stream))
        if pack:
            _kernels._check(k.shred_encode_pack(
                tok.data_ptr(), start.data_ptr(), counts.data_ptr(),
                ends.data_ptr(), W, ids.data_ptr(), ids.element_size(),
                stream))

    call()
    return tuple(_device_ms(lambda: call(*f), device, reps)
                 for f in ((True, True), (True, False), (False, True)))


def measure_encode_kernel(tok, text: str, device: torch.device) -> dict:
    """E1 alone over every whitespace chunk of ``text``, bytes and
    lengths already on the device: on the card its two launches
    (:func:`encode_launch_ms`), on the CPU ``encode_core``'s plain
    version on the host clock; and, each alone, the pageable upload of
    the bytes and lengths and the download of the ids."""
    from .ops import encode_ops

    flat = np.frombuffer(text.encode(), np.uint8).copy()
    lens = encode_ops.ws_chunk_lens(flat).astype(np.int32)
    v = 256 + len(tok.merges)
    table = (encode_ops.build_rank_table(tok.merges, v, device)
             if v <= encode_ops.DENSE_V_MAX
             else encode_ops.build_merge_table(tok.merges, device))
    up = {}

    def upload():
        up["f"] = torch.from_numpy(flat).to(device)
        up["l"] = torch.from_numpy(lens).to(device)
        _sync(device)

    upload()
    up_s = _best_s(upload)
    df, dl = up["f"], up["l"]
    ids, _ = encode_ops.encode_core(df, dl, table, v=v)
    if device.type == "cuda":
        kern_ms, merge_ms, pack_ms = encode_launch_ms(df, dl, table, v,
                                                      device)
    else:
        kern_ms = _device_ms(lambda: encode_ops.encode_core(
            df, dl, table, v=v), device, reps=3)
        merge_ms = pack_ms = float("nan")
    down_s = _best_s(lambda: encode_ops.ids_to_numpy(ids))
    want = tok.encode_array(text)
    if not np.array_equal(encode_ops.ids_to_numpy(ids), want):
        raise BenchError("encode_core's ids differ from encode_array's")
    return {"kern_mbs": len(flat) / 1e6 / (kern_ms / 1e3),
            "kern_ms": kern_ms, "merge_ms": merge_ms, "pack_ms": pack_ms,
            "upload_ms": up_s * 1e3, "download_ms": down_s * 1e3,
            "chunks": len(lens)}


def measure_encode(corpus: str, device: torch.device) -> dict:
    """Encode/decode MB/s of the headline merges on the corpus's first
    4 MB: the native CPU encoder, the card's whole-text encode_array
    (ids == the CPU's), encode_batch_arrays over 64 KB documents (each
    decodes to its document) and decode (round trip exact); then E1
    alone (:func:`measure_encode_kernel`)."""
    from .tokenizer import Tokenizer

    tok = Tokenizer.train(corpus, vocab_size=VOCAB, min_pair_freq=MIN_FREQ,
                          character_coverage=COVERAGE, backend="cpu",
                          tie_break="faithful", device=device)
    text = _read_text(corpus, 4 * 10**6)
    nbytes = len(text.encode())
    ids = tok.encode_array(text)                     # warm
    cpu_s = _best_s(lambda: tok.encode_array(text))
    if tok.decode(ids) != text:
        raise BenchError("decode does not round-trip the CPU ids")
    dec_s = _best_s(lambda: tok.decode(ids))

    tok.backend = "cuda"
    with launches(device, "E1") as got:
        dev_ids = tok.encode_array(text)             # warm-up: the build
        if not np.array_equal(np.asarray(dev_ids, np.int64),
                              np.asarray(ids, np.int64)):
            raise BenchError("the device encode's ids differ from the "
                             "native CPU encoder's")
        dev_s = _best_s(lambda: tok.encode_array(text))
        docs = [text[i:i + 65536] for i in range(0, len(text), 65536)]
        batch = tok.encode_batch_arrays(docs)        # warm-up
        batch_s = _best_s(lambda: tok.encode_batch_arrays(docs))
        if [tok.decode(d) for d in batch] != docs:
            raise BenchError("encode_batch_arrays does not round-trip")
        kern = measure_encode_kernel(tok, text, device)
    mb = nbytes / 1e6
    return {"cpu_mbs": mb / cpu_s, "dev_mbs": mb / dev_s,
            "batch_mbs": mb / batch_s, "dec_mbs": mb / dec_s,
            "n_ids": len(ids), "docs": len(docs), "launches": got, **kern}


def _unigram(corpus: str, device: torch.device, work: str, tag: str,
             encode_trials: int, **cfg) -> dict:
    """Train a Unigram LM on the corpus (U1 E-steps, U2 prunes), save,
    load and encode the first 1 MB (U2) with the quality metrics."""
    from .models.unigram import UnigramTokenizer, UnigramTrainer

    with launches(device, "U1", "U2") as got:
        t = UnigramTrainer(device=device, **cfg)
        t.load_corpus(corpus)
        t0 = time.perf_counter()
        n = t.train()
        _sync(device)
        train_s = time.perf_counter() - t0
        path = os.path.join(work, f"{tag}.model")
        t.save(path)
        tok = UnigramTokenizer.load(path, device=device)
        text = _read_text(corpus, 10**6)
        ids = tok.encode_array(text)                 # warm
        if encode_trials:
            enc_s = _best_s(lambda: tok.encode_array(text), encode_trials)
    n_words = max(text.count(" ") + text.count("\n") + 1, 1)
    out = {"vocab": n, "train_s": train_s,
           "train_mbs": os.path.getsize(corpus) / 1e6 / train_s,
           "final_ll": t.final_ll, "ll_per_word": t.final_ll_per_word,
           "pieces_per_word": len(ids) / n_words, "n_ids": len(ids),
           "launches": got}
    if encode_trials:
        out["enc_mbs"] = len(text.encode()) / 1e6 / enc_s
    return out


def measure_unigram(corpus: str, device, work: str) -> dict:
    """1,024-piece Unigram LM (seed 10,000) on the whole corpus, and
    Viterbi encode MB/s on 1 MB of it (best of 2)."""
    return _unigram(corpus, device, work, "uni", 2,
                    target_vocab_size=1024, seed_size=10_000)


def measure_unigram_default(corpus: str, device, work: str) -> dict:
    """Unigram at its default config: 8,192 pieces, seed 100,000."""
    return _unigram(corpus, device, work, "uni_default", 0,
                    target_vocab_size=8192, seed_size=100_000)


def measure_giant_vocab(corpus: str, device) -> dict:
    """Vocab GIANT_VOCAB (min_pair_freq 2, coverage 1.0): auto routing
    above 4096 takes the giant engine (K3).  Warm-up, then best of 2."""
    cfg = dict(vocab=GIANT_VOCAB, character_coverage=1.0, min_pair_freq=2)
    with launches(device, "K3") as got:
        train_once(corpus, device, **cfg)            # warm-up
        dt, n = min(train_once(corpus, device, **cfg) for _ in range(2))
    return {"merges": n, "seconds": dt,
            "mbs": os.path.getsize(corpus) / 1e6 / dt,
            "ms_per_merge": dt / max(n, 1) * 1e3, "launches": got}


@contextlib.contextmanager
def giant_layouts():
    """Keeps every giant layout that ``giant_train`` builds inside the
    block in the list it yields."""
    from .ops import bpe_giant

    built: list = []
    build = bpe_giant.build_giant_layout

    def recorded(*args, **kw):
        lay = build(*args, **kw)
        if lay is not None:
            built.append(lay)
        return lay

    bpe_giant.build_giant_layout = recorded
    try:
        yield built
    finally:
        bpe_giant.build_giant_layout = build


def measure_big_vocab(corpus: str, device) -> dict:
    """BASELINE config 2: BPETrainer(GIANT_VOCAB, min_pair_freq 2000,
    coverage 1.0, the other arguments at their defaults) on the corpus
    of :func:`make_big_corpus`, ``BIG_RUNS`` times (each load_corpus ->
    train, timed as :func:`train_once` times it; the kernels are built
    first).  Returns the merges, every run's train() seconds and the
    best's MB/s, the engine auto routing took (the giant engine when it
    built a layout, whose chunk width and shape are returned, else the
    flat one), the kernels' launches (K3 or F1 must launch on a card)
    and the peak device memory of a run."""
    from .ops import _kernels

    dev = resolve_device(device)
    if dev.type == "cuda":
        _kernels.lib()
    fns = _counters()
    before = {k: fns[k].launches for k in ("K3", "F1")}
    times, peak = [], 0
    with giant_layouts() as built:
        for _ in range(BIG_RUNS):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            dt, n = train_once(corpus, dev, vocab=GIANT_VOCAB, **BIG)
            times.append(dt)
            if dev.type == "cuda":
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
        layout = None
        if built:
            (L, W), NC = built[-1].tw.shape, built[-1].presT.shape[1]
            layout = dict(L=L, W=W, NC=NC, cw=W // NC,
                          n_words=built[-1].n_words)
    got = {k: fns[k].launches - n0 for k, n0 in before.items()}
    engine, kernel = ("giant", "K3") if layout else ("flat", "F1")
    if dev.type == "cuda" and got[kernel] == 0:
        raise BenchError(f"{kernel} never launched on {dev}")
    return {"merges": n, "seconds": min(times), "times": times,
            "mbs": os.path.getsize(corpus) / 1e6 / min(times),
            "engine": engine, "layout": layout,
            "chunk_width": layout["cw"] if layout else None,
            "peak_bytes": peak, "launches": got}


def measure_daemon(corpus: str, device: torch.device, work: str) -> dict:
    """The warm-daemon CLI workflow: after one warming request, a fresh
    ``python -m shredword_tpu_torch`` client process (routed by
    SHREDWORD_TORCH_DAEMON) trains vocab 400 on a 2 MB slice through the
    warm daemon.  The daemon is stopped at the end, also on failure."""
    from . import daemon

    small = os.path.join(work, "daemon_corpus.txt")
    with open(small, "w") as g:
        g.write(_read_text(corpus, 2 * 10**6))
    sock = os.path.join(work, "daemon.sock")
    argv = ["train", "--corpus", small, "--model",
            os.path.join(work, "daemon.model"), "--vocab-size", "400",
            "--min-pair-freq", "2", "--device", str(device)]
    if not daemon.start(sock, wait=120.0, idle_timeout=900.0):
        raise BenchError("the daemon failed to start")
    try:
        t0 = time.perf_counter()
        r = daemon.request(argv, socket_path=sock)    # warming call
        first_s = time.perf_counter() - t0
        if r is None or r["rc"] != 0:
            raise BenchError(f"daemon train failed: {r}")
        env = dict(os.environ, **{daemon.ROUTE_ENV: "1",
                                  daemon.SOCKET_ENV: sock})
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "shredword_tpu_torch",
                            *argv], env=env, capture_output=True, text=True,
                           cwd=ROOT, timeout=600)
        client_s = time.perf_counter() - t0
        if p.returncode != 0:
            raise BenchError(f"client train failed: {p.stderr[-500:]}")
    finally:
        state = daemon.stop_state(sock)
    if state != "stopped":
        raise BenchError(f"the daemon did not stop: {state}")
    return {"first_call_s": first_s, "fresh_client_s": client_s}


def side_metrics(corpus: str, device: torch.device, work: str) -> None:
    """bench.py's side metrics, in its order, on standard error."""
    t0 = time.perf_counter()
    pre = measure_presplit(corpus)
    _say(f"gpt pre-split: native {pre['native']:.1f} MB/s vs regex module "
         f"{pre['regex']:.2f} MB/s ({pre['x']:.1f}x, {pre['chunks']} "
         f"chunks, output identical) [{time.perf_counter() - t0:.1f} s]")

    t0 = time.perf_counter()
    e = measure_encode(corpus, device)
    _say(f"encode: cpu native {e['cpu_mbs']:.2f} MB/s ({e['n_ids']} ids, "
         f"round-trip exact), {device} whole-text {e['dev_mbs']:.2f} MB/s "
         f"(ids == cpu), {device} batch of {e['docs']} 64 KB documents "
         f"{e['batch_mbs']:.2f} MB/s; decode {e['dec_mbs']:.2f} MB/s; "
         f"{_launch_note(e['launches'])}; the reference has no encoder to "
         f"compare [{time.perf_counter() - t0:.1f} s]")
    what = ("csrc/encode.cu's merge + pack launches alone, launched "
            "directly on device-resident bytes, lengths and offsets"
            if device.type == "cuda" else
            "encode_core's plain version on the host clock")
    _say(f"encode kernel-only (E1: {what}): {e['kern_ms']:.4f} ms per "
         f"call (merge {e['merge_ms']:.4f} ms, pack {e['pack_ms']:.4f} ms, "
         f"each alone), {e['kern_mbs']:.1f} MB/s over all {e['chunks']} "
         f"whitespace chunks; pageable upload {e['upload_ms']:.3f} ms, "
         f"ids download {e['download_ms']:.3f} ms, each alone")

    t0 = time.perf_counter()
    u = measure_unigram(corpus, device, work)
    _say(f"unigram: {u['vocab']}-piece LM (seed 10k) trained in "
         f"{u['train_s']:.2f} s ({u['train_mbs']:.2f} MB/s); final corpus "
         f"LL {u['final_ll']:.6g} ({u['ll_per_word']:.4f}/word), "
         f"{u['pieces_per_word']:.3f} pieces/word; viterbi encode "
         f"{u['enc_mbs']:.2f} MB/s ({u['n_ids']} ids); "
         f"{_launch_note(u['launches'])} [{time.perf_counter() - t0:.1f} s]")

    t0 = time.perf_counter()
    u = measure_unigram_default(corpus, device, work)
    _say(f"unigram DEFAULT config (8192 pieces, seed 100k): "
         f"{u['vocab']} pieces in {u['train_s']:.2f} s "
         f"({u['train_mbs']:.2f} MB/s); final corpus LL "
         f"{u['final_ll']:.6g} ({u['ll_per_word']:.4f}/word), "
         f"{u['pieces_per_word']:.3f} pieces/word; "
         f"{_launch_note(u['launches'])} [{time.perf_counter() - t0:.1f} s]")

    t0 = time.perf_counter()
    g = measure_giant_vocab(corpus, device)
    _say(f"{GIANT_VOCAB}-vocab train (giant engine): {g['merges']} merges "
         f"in {g['seconds']:.6f} s (best of 2 after a warm-up), "
         f"{g['mbs']:.4f} MB/s, {g['ms_per_merge']:.6f} ms/merge; "
         f"{_launch_note(g['launches'])} [{time.perf_counter() - t0:.1f} s]")

    t0 = time.perf_counter()
    d = measure_daemon(corpus, device, work)
    _say(f"cli daemon: first (warming) call {d['first_call_s']:.3f} s; "
         f"fresh client process on the warm daemon "
         f"{d['fresh_client_s']:.3f} s (2 MB, vocab 400, train end to "
         f"end) [{time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------

def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m shredword_tpu_torch.bench",
        description="BPE training MB/s of the port against the native "
                    "faithful engine; prints one JSON line last")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain "
                        "versions, for the tests)")
    p.add_argument("--corpus", default=None,
                   help="the bench corpus: reused when it is the 16 MB "
                        "corpus (size and sha256), written when missing; "
                        "any other existing file is refused, never "
                        "overwritten (default: under the temp dir, "
                        "rewritten there as needed)")
    p.add_argument("--raw-mb", type=float, default=RAW_MB,
                   help="corpus size in MB (the tests use 1 and less)")
    p.add_argument("--no-side", action="store_true",
                   help="run the baseline, the headline and the "
                        "cross-check only")
    return p


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        _say(f"card: {card_line()} ({torch.cuda.get_device_name(device)})")
    else:
        _say(f"device {device}: the kernels' plain versions; not a card "
             "measurement")
    corpus = args.corpus or default_corpus(args.raw_mb)
    reused = ensure_corpus(corpus, args.raw_mb)
    raw_bytes = os.path.getsize(corpus)
    _say(f"corpus {corpus}: {raw_bytes} bytes "
         f"({'reused, digest checked' if reused else 'generated'})")

    with tempfile.TemporaryDirectory(prefix="shredword_bench_") as work:
        kind, ref_dt, ref_n = measure_baseline(corpus)
        headline = os.path.join(work, "headline")
        dt, n, _ = measure_train(corpus, device, save_to=headline)
        outs = check_device_engines(corpus, device, work)
        if read_model(headline) != outs["hist"]:
            raise BenchError("the timed run's model differs from the "
                             "cross-checked engines'")
        mb = raw_bytes / 1e6
        ours, base = mb / dt, mb / ref_dt
        _say(f"corpus {mb:.1f} MB; baseline ({kind}): "
             f"{ref_dt:.6f} s ({ref_n} merges, {base:.4f} MB/s); {device}: "
             f"{dt:.6f} s best of {RUNS} ({n} merges, {ours:.4f} MB/s)")
        if not args.no_side:
            side_metrics(corpus, device, work)
    print(json.dumps({"metric": "train_mb_s", "value": round(ours, 2),
                      "unit": "MB/s", "vs_baseline": round(ours / base, 3)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
