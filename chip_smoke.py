#!/usr/bin/env python3
"""Smoke run of the PyTorch port (shredword_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. environment: card name and power limit, torch/CUDA/nvcc versions,
     and the build of the CUDA kernel library from the checkout's sources
  2. the fused hist kernel against its plain PyTorch version on the card,
     on seeded random corpora at vocab 768 and 4096 (chunked calls, an
     unk byte, 'aaaa' runs), then timed at the main path's shapes (the
     bench corpus layout, L 16, about 80k columns): records, tables and
     tokens must be identical
  3. the main path at the headline configuration: BPETrainer(vocab 768,
     min_pair_freq 50, coverage 0.9999, backend "cuda") load_corpus ->
     train -> save on the 16 MB corpus of bench.make_corpus; the kernel
     must have launched, and the .model/.vocab bytes must equal the
     port's flat engine on the card and the JAX package's golden digest
     (tests/golden/bench_v768.json)
  4. the same at vocab 4096, cross-checked against the flat engine
  5. the giant kernel against its plain PyTorch version on the card, on
     seeded random corpora at vocab 5120 and 8192 (chunk widths 512 and
     1024, chunked calls, an unk byte, 'aaaa' runs, a min_pair_freq
     stop, a call past the end): records, tokens, tables, presence and
     row-max bounds must be identical; then both timed on the bench
     corpus's giant layout at vocab 32768 for the first 128 merges
  6. the giant main path: BPETrainer(vocab 32768, min_pair_freq 2,
     coverage 1.0, backend "cuda") load_corpus -> train -> save on the
     same corpus (the JAX bench's measure_giant_vocab configuration);
     the giant kernel must have launched, and the bytes must equal the
     port's flat engine on the card
  7. engine "giant" at the headline configuration (vocab 768): the bytes
     must equal the JAX golden digest, so hist == giant == flat there

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(unk_id=-1, character_coverage=0.9999, min_pair_freq=50)
GIANT = dict(unk_id=-1, character_coverage=1.0, min_pair_freq=2)
GIANT_VOCAB = 32768
TPU_KERNEL = {768: "shredword_tpu/ops/bpe_hist.py:488",     # _fused_kernel
              4096: "shredword_tpu/ops/bpe_hist.py:690",    # _fused_kernel_big
              GIANT_VOCAB: "shredword_tpu/ops/bpe_giant.py:292"}  # _giant_kernel
TIMED_MERGES = 128


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| (0 when equal), without int64 copies of a 4 GB
    table."""
    if torch.equal(a, b):
        return 0
    return int((a.int() - b.int()).abs().max())


def elapsed_ms(fn, device: torch.device) -> float:
    """Device time of fn() in ms, between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


# ---------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------

def phase_env() -> str:
    from shredword_tpu_torch.ops import _kernels

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" torch CUDA {torch.version.cuda}")
    print(f"[env] {run([_kernels._nvcc(), '--version']).splitlines()[-1]}")
    path, out = _kernels.build(("-Xptxas", "-v"))
    print(f"[env] built {os.path.relpath(path, ROOT)} in "
          f"{_kernels.build_seconds:.2f} s")
    for line in out.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"[env] ptxas: {line.strip()}")
    return card


# ---------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------

def random_corpus(seed: int, n_words: int, unk: int):
    """Seeded words over a skewed 26-letter alphabet (so hundreds of
    pairs stay frequent), with 'aaaa' runs and an unk byte."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, 27) ** 0.8
    lens = rng.randint(1, 15, n_words)
    lens[:50] = 12                                      # 'aaaa...' runs
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = (97 + rng.choice(26, len(word_id), p=p / p.sum())).astype(
        np.int32)
    tokens[word_id < 50] = 97
    tokens[rng.rand(len(tokens)) < 0.01] = unk
    wc_word = rng.randint(1, 500, n_words).astype(np.int32)
    return tokens, word_id, wc_word


def hist_state(layout, v, unk, device) -> list[torch.Tensor]:
    from shredword_tpu_torch.ops import bpe_hist

    tw = torch.tensor(layout.tw, device=device)
    wc = torch.tensor(layout.wcount.reshape(-1), device=device)
    return [tw, wc, bpe_hist.init_hist(tw, wc, unk, v)]


def giant_state(layout, v, unk, device) -> list[torch.Tensor]:
    from shredword_tpu_torch.ops import bpe_giant

    tw = torch.tensor(layout.tw, device=device)
    wc = torch.tensor(layout.wc.reshape(-1), device=device)
    presT = torch.tensor(layout.presT, device=device)
    hist, rowmax = bpe_giant.init_tables(tw, wc, unk, v)
    return [tw, wc, hist, presT, rowmax]


def run_both(kernel, plain, state, device, *, merges, steps, **kw):
    """Drive a kernel and its plain version call by call, each on its
    own state() (tensors updated in place), then one untimed call past
    the end (every step only confirms the pick); returns (max abs
    difference over records and state, kernel ms, plain ms, merges
    done)."""
    sk, sp = state(), state()
    err, ms_k, ms_p, n_done, done = 0, 0.0, 0.0, 0, 0

    def call(ckw, timed=True):
        nonlocal err, ms_k, ms_p
        out = {}
        ms = [elapsed_ms(lambda: out.__setitem__("k", kernel(*sk, **ckw)),
                         device),
              elapsed_ms(lambda: out.__setitem__("p", plain(*sp, **ckw)),
                         device)]
        if timed:
            ms_k, ms_p = ms_k + ms[0], ms_p + ms[1]
        for a, b in [(out["k"], out["p"]), *zip(sk, sp)]:
            err = max(err, max_abs_diff(a, b))
        return out["k"]

    while n_done < merges and not done:
        allowed = merges - n_done
        recs = call(dict(kw, n_done=n_done, init_done=done, allowed=allowed,
                         steps=min(steps, allowed)))
        n_new = int(recs[:, 3].sum())
        done = int(n_new < min(steps, allowed))
        n_done += n_new
    call(dict(kw, n_done=n_done, init_done=1, allowed=0, steps=8),
         timed=False)
    return err, ms_k, ms_p, n_done


def token_arrays(corpus, device, cfg):
    """(tokens, word_id, per-word counts) of the corpus as the trainer
    prepares them under cfg."""
    from shredword_tpu_torch import BPETrainer

    probe = BPETrainer(target_vocab_size=768, backend="cuda", device=device,
                       **cfg)
    try:
        probe.load_corpus(corpus)
        tokens, word_id, _ = probe._token_arrays()
        return tokens, word_id, probe._arrays.counts.astype(np.int32)
    finally:
        probe.destroy()


def run_hist_both(layout, v, device, *, unk, **kw):
    from shredword_tpu_torch.ops import _kernels

    return run_both(_kernels.hist_fused_train,
                    _kernels.hist_fused_train_plain,
                    lambda: hist_state(layout, v, unk, device), device,
                    unk=unk, **kw)


def phase_kernel_vs_plain(device: torch.device, bench_layout) -> dict:
    from shredword_tpu_torch.ops import bpe_hist

    for v, merges, steps in ((768, 300, 128), (4096, 400, 96)):
        unk = 122                                       # the byte 'z'
        tokens, word_id, wc_word = random_corpus(v, 20000, unk)
        layout = bpe_hist.build_layout(tokens, word_id, wc_word, 64)
        err, _, _, n = run_hist_both(layout, v, device, unk=unk, min_freq=2,
                                     merges=merges, steps=steps)
        print(f"[kernel] random corpus v={v}: {n} merges in chunks of "
              f"{steps}, max |kernel - plain| = {err}")
        check(err == 0 and n == merges, f"kernel == plain at v={v}")
    timing = {}
    for v in (768, 4096):
        err, ms_k, ms_p, n = run_hist_both(
            bench_layout, v, device, unk=HEADLINE["unk_id"],
            min_freq=HEADLINE["min_pair_freq"], merges=TIMED_MERGES,
            steps=TIMED_MERGES)
        check(err == 0 and n == TIMED_MERGES, f"bench layout v={v}")
        timing[v] = dict(max_abs_err=err, ms=ms_k / n, plain_ms=ms_p / n)
        print(f"[kernel] bench layout {tuple(bench_layout.tw.shape)} v={v}:"
              f" first {n} merges, kernel {ms_k / n:.4f} ms/merge, plain "
              f"{ms_p / n:.4f} ms/merge, max |kernel - plain| = {err}")
    return timing


# ---------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------

def train_and_save(corpus, out_dir, vocab, device, engine="auto",
                   cfg=HEADLINE):
    from shredword_tpu_torch import BPETrainer

    t = BPETrainer(target_vocab_size=vocab, backend="cuda", device=device,
                   engine=engine, **cfg)
    try:
        t.load_corpus(corpus)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        n = t.train()
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        mp = os.path.join(out_dir, f"{engine}_{vocab}.model")
        vp = os.path.join(out_dir, f"{engine}_{vocab}.vocab")
        t.save(mp, vp)
        raw = t._arrays.total_raw_bytes
    finally:
        t.destroy()
    with open(mp, "rb") as f, open(vp, "rb") as g:
        return n, secs, raw, peak, f.read(), g.read()


def phase_main_path(corpus, out_dir, vocab, device, *, engine="auto",
                    cfg=HEADLINE, kernel="hist_fused_train",
                    golden=None) -> int:
    """Train, save and cross-check one configuration; returns the
    launches of `kernel` in the trainer's run (every count is set to 0
    just before it and read just after)."""
    from shredword_tpu_torch.ops import _kernels

    counters = (_kernels.hist_fused_train, _kernels.giant_train_step)
    for k in counters:
        k.launches = 0
    n, secs, raw, peak, model, vocab_b = train_and_save(
        corpus, out_dir, vocab, device, engine, cfg)
    launches = getattr(_kernels, kernel).launches
    tag = f"[main] vocab {vocab}, engine {engine}"
    print(f"{tag}: {n} merges, train {secs:.4f} s, "
          f"{raw / 1e6 / secs:.3f} MB/s over {raw / 1e6:.2f} MB raw, "
          f"{launches} {kernel} calls, peak device memory "
          f"{peak / 1e9:.3f} GB")
    check(launches > 0, f"the main path launched {kernel}")
    check(n > 0, "merges learned")
    fn, fsecs, _, _, fmodel, fvocab = train_and_save(
        corpus, out_dir, vocab, device, "flat", cfg)
    print(f"{tag}: flat engine {fn} merges in {fsecs:.4f} s")
    check(model == fmodel and vocab_b == fvocab,
          f"{engine} == flat .model/.vocab bytes at vocab {vocab}")
    if golden is not None:
        check(hashlib.sha256(model).hexdigest() == golden["model_sha256"]
              and hashlib.sha256(vocab_b).hexdigest()
              == golden["vocab_sha256"] and n == golden["merges"],
              "bytes equal the JAX package's golden digest")
        print(f"{tag}: .model/.vocab match the JAX golden digest "
              f"{golden['model_sha256'][:16]}...")
    return launches


# ---------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------

def run_giant_both(layout, v, device, *, unk, **kw):
    from shredword_tpu_torch.ops import _kernels

    cw = layout.tw.shape[1] // layout.presT.shape[1]
    return run_both(_kernels.giant_train_step,
                    _kernels.giant_train_step_plain,
                    lambda: giant_state(layout, v, unk, device), device,
                    unk=unk, nc_used=-(-layout.n_words // cw), **kw)


def phase_giant_vs_plain(device: torch.device, bench_layout) -> dict:
    from shredword_tpu_torch.ops import bpe_giant

    for v, cw, min_freq, merges, steps in ((5120, 512, 2, 700, 128),
                                           (8192, 1024, 2, 900, 256),
                                           (5120, 1024, 20000, 700, 64)):
        unk = 122                                       # the byte 'z'
        tokens, word_id, wc_word = random_corpus(v + cw, 30000, unk)
        layout = bpe_giant.build_giant_layout(tokens, word_id, wc_word, v,
                                              cw=cw)
        err, _, _, n = run_giant_both(layout, v, device, unk=unk,
                                      min_freq=min_freq, merges=merges,
                                      steps=steps)
        print(f"[giant] random corpus v={v} cw={cw} min_freq={min_freq}: "
              f"{n} merges in chunks of {steps}, max |kernel - plain| = "
              f"{err}")
        check(err == 0 and (n == merges) == (min_freq == 2) and n > 0,
              f"giant kernel == plain at v={v} cw={cw}")
    err, ms_k, ms_p, n = run_giant_both(
        bench_layout, GIANT_VOCAB, device, unk=GIANT["unk_id"],
        min_freq=GIANT["min_pair_freq"], merges=TIMED_MERGES,
        steps=TIMED_MERGES)
    check(err == 0 and n == TIMED_MERGES, f"bench layout v={GIANT_VOCAB}")
    print(f"[giant] bench layout {tuple(bench_layout.tw.shape)} "
          f"v={GIANT_VOCAB}: first {n} merges, kernel {ms_k / n:.4f} "
          f"ms/merge, plain {ms_p / n:.4f} ms/merge, max |kernel - plain| "
          f"= {err}")
    return dict(max_abs_err=err, ms=ms_k / n, plain_ms=ms_p / n)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bench
    from shredword_tpu_torch.ops import bpe_giant, bpe_hist

    device = torch.device("cuda", 0)
    card = phase_env()
    with open(os.path.join(ROOT, "tests", "golden", "bench_v768.json")) as f:
        golden = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        bench.make_corpus(corpus)
        bench_layout = bpe_hist.build_layout(
            *token_arrays(corpus, device, HEADLINE), 64)
        timing = phase_kernel_vs_plain(device, bench_layout)
        launches = {768: phase_main_path(corpus, tmp, 768, device,
                                         golden=golden),
                    4096: phase_main_path(corpus, tmp, 4096, device)}
        giant_layout = bpe_giant.build_giant_layout(
            *token_arrays(corpus, device, GIANT), GIANT_VOCAB)
        timing[GIANT_VOCAB] = phase_giant_vs_plain(device, giant_layout)
        del giant_layout
        launches[GIANT_VOCAB] = phase_main_path(
            corpus, tmp, GIANT_VOCAB, device, cfg=GIANT,
            kernel="giant_train_step")
        phase_main_path(corpus, tmp, 768, device, engine="giant",
                        kernel="giant_train_step", golden=golden)
    kernels = [dict(name=f"hist_fused_train@v{v}", route="cuda",
                    source="shredword_tpu_torch/csrc/hist_fused.cu",
                    replaces=TPU_KERNEL[v], launches=launches[v],
                    **timing[v]) for v in (768, 4096)]
    kernels.append(dict(name=f"giant_train@v{GIANT_VOCAB}", route="cuda",
                        source="shredword_tpu_torch/csrc/giant.cu",
                        replaces=TPU_KERNEL[GIANT_VOCAB],
                        launches=launches[GIANT_VOCAB],
                        **timing[GIANT_VOCAB]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
