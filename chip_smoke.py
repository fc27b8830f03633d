#!/usr/bin/env python3
"""Smoke run of the PyTorch port (shredword_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. environment: card name and power limit, torch/CUDA/nvcc versions,
     and the build of the CUDA kernel library from the checkout's sources,
     with a second build of it that counts each phase's cycles
     (-DSHRED_PHASE_CLOCKS), all sources of both at once
  2. the fused hist kernel against its plain PyTorch version on the card,
     on seeded random corpora at vocab 768 and 4096 (chunked calls, an
     unk byte, 'aaaa' runs), then timed at the main path's shapes (the
     bench corpus layout, L 16, about 80k columns): records, tables and
     tokens must be identical
  3. the main path at the headline configuration: BPETrainer(vocab 768,
     min_pair_freq 50, coverage 0.9999, backend "cuda") load_corpus ->
     train -> save on the 16 MB corpus of make_corpus; the kernel
     must have launched, and the .model/.vocab bytes must equal the
     port's flat engine on the card (F1, csrc/flat.cu, which must have
     launched: two independent kernel designs) and the JAX package's
     golden digest (tests/golden/bench_v768.json); the merge loop's ms
     per merge over the whole run, from CUDA events around each kernel
     call inside train() (no synchronise added to the run)
  4. the same at vocab 4096, cross-checked against the flat engine
  5. the giant kernel against its plain PyTorch version on the card, on
     seeded random corpora at vocab 5120 and 8192 (chunk widths 512,
     1024 and 2048, chunked calls, an unk byte, 'aaaa' runs, a min_pair_freq
     stop, a call past the end): records, tokens, tables, presence and
     row-max bounds must be identical; then both timed on the bench
     corpus's giant layout at vocab 32768 for the first 128 merges, and
     for a late window of 128 merges from merge 16128 (one state advanced
     by the kernel, then kernel and plain from two clones of it); the
     mean n_refresh (row reads per merge) of each, and the bound of each
     from what its merges move on this data (counted in a rerun)
  6. the giant main path: BPETrainer(vocab 32768, min_pair_freq 2,
     coverage 1.0, backend "cuda") load_corpus -> train -> save on the
     same corpus (the JAX bench's measure_giant_vocab configuration);
     the giant kernel must have launched, and the bytes must equal the
     port's flat engine on the card; whole-run ms per merge as in 3
  7. engine "giant" at the headline configuration (vocab 768): the bytes
     must equal the JAX golden digest, so hist == giant == flat there;
     then, over a world-size-1 NCCL group that phases 7-11 share, one
     train() at vocab 768, 4096 and 32768, one hist_train(sparse=True)
     and one sharded train() (NCCL world 1) at vocab 768 under
     torch.profiler: kernel launches per wrapper call (the persistent
     kernels: 1; K4's chain: its merges + 2) and the device busy share
  8. K4's chain (hist_sharded_train: one cooperative launch and one
     all_reduce per merge) against its plain version on the card, call by
     call with a call past the end, on seeded random corpora at vocab 768
     and 4096 (records, tokens and tables identical), then the first 128
     merges in one call on the bench layout at vocab 768 and 4096: the
     device ms per merge (the call enqueued behind a spin kernel), the
     whole loop ms per merge (the host enqueueing it), the plain
     version's, the launches of the call, and the bound from what the
     merges move on this data (counted in a rerun)
  9. the same for K5 (hist_sparse_train: one persistent launch per call),
     presence included, plus a min_pair_freq stop
 10. hist_train(sparse=True) at the headline configuration: merges and
     frequencies equal the dense engine's; its whole-run ms per merge
 11. sharded BPETrainer at the headline configuration through the public
     API: world size 1 on NCCL (its whole-run ms per merge), then 2 gloo
     ranks on cuda:0 (spawned): bytes equal the JAX golden digest; 2
     ranks at vocab 4096: bytes equal the fused hist engine's.  Each
     group's first all_reduce (the communicator's set-up) is timed apart
     from train()
 12. the phase clocks: the hist kernel at vocab 768 and 4096, K5 and K4's
     chain at 768, the giant kernel at 32768 and F1 on the long-word
     corpus at 32768 (each the first 128 merges and the whole run), as
     the main path calls them, once with each build from equal states:
     records and state must be identical; prints the µs per merge of
     each phase (F1 also its chunks visited, words merged past their
     signatures and segment maxima recomputed per merge)
 13. encode, with the merges that phases 3, 4 and 6 trained (vocab 768
     and 4096 on the dense rank table, 32768 on the hash table): the
     encode kernel (csrc/encode.cu) against its two plain versions on
     the card, on seeded corpus slices (1-64 bytes; then with chunks of
     65-300 bytes), 'aaaa' runs, a byte no merge names, the edges of its
     length classes (tests/torch_encode_cases.py: chunks of 1, 2, 8, 9,
     16, 17, 32, 33, 64 and 65 bytes, 'a' runs of 2-70 bytes under (a, a)
     merges, windows mixing one-byte chunks with longer ones; dense and
     hash tables) and 'fhus': ids and counts identical; then the main
     path as the JAX bench's
     measure_encode runs it (bench.py:247-283) on the first 4,000,000
     characters of the corpus: Tokenizer(merges, backend "cuda")
     .encode_array must equal the native CPU encoder's ids and decode
     must round-trip, encode_batch_arrays over 64 KB documents must equal
     the per-document calls, and the GPT pattern on the first 1 MB must
     equal the CPU ids; prints encode / decode MB/s (best of 3 after a
     warm-up), the chunks and the distinct chunks, the kernel's device ms
     per call over every chunk of the text (CUDA events) and over its GPT
     chunks, its plain version's, its launches per call (torch.profiler),
     its bound from the bytes it moves and the rank lookups it makes
     (counted in a rerun), and, at 64 KB and 4 MB, whitespace and GPT
     chunks encoded
     directly (the main path) against the route through the distinct
     chunks (native dedup, device, native expansion), layer by layer
 14. Unigram: the lattice kernels of csrc/unigram.cu (U1 fb_kernel, the
     EM forward-backward; U2 viterbi_kernel; sixteen lanes per word)
     against their plain versions on the card, on the seeded lattices of
     tests/torch_unigram_cases.py (absent cells, an all-absent row, an
     uncovered word, pieces pruned to -1e30, lengths 1 and L, ties, L 70
     for the global-scratch mode, words whose one path through pruned
     pieces overflows U1's posteriors): U1's counts within rtol 1e-5 /
     atol 1e-6 and its log-likelihood within 1e-6 relative, U2
     identical; the overflow corpus of tests/torch_unigram_cases.py
     trained on the card and with device="cpu": finite log-probs, the
     same pieces, a model that encodes its corpus; then on the default
     config's real slabs at the seed pieces (U1 on the three E-step
     slabs, U2 on the first prune's first slab, scores only as train()
     calls it): checked and timed (CUDA events), the plain versions'
     time, launches per call (torch.profiler), the bound from the cells
     inside the words and the operations on the present cells, and U1
     again with no hot ids in shared memory (every count a global
     atomic) and with every present cell's id distinct (no hot-piece
     atomics); then the main path at the JAX bench's default config
     (bench.py:400-420): UnigramTrainer(8192, seed 100,000) load_corpus
     -> train -> save on the 16 MB corpus (8192 pieces; U1 and U2
     launches per train(), device busy share, final LL, the host layers
     of train(), its e_step and prune seconds),
     UnigramTokenizer.load(...).encode_array on its first 1,000,000
     characters (decodes to the normalized text; ids == the
     host DP encode_word on every distinct word, or another path of the
     same score within 1e-6 relative; pieces per word, encode and decode
     MB/s); the bench's 1,024-piece config (bench.py:378-397) on the card
     and with device="cpu": pieces identical and log_probs within 1e-5
     (a prune near-tie may flip a piece only if its loss lies within 1e-6
     relative of that prune's cutoff, printed); UnigramTrainer(mesh=...)
     over NCCL world 1 == the single-device pieces
 15. the row-sharded giant engine (parallel/giant.py) and sharded flat
     (parallel/train.py): G1 (csrc/giant_sharded.cu, giant_sharded_train,
     on each rank's chunked layout with its presence index) against its
     plain version on the card, call by call with a call past the end,
     in both forms -- alone (no reduce: one persistent launch a call, as
     sharded training runs at world 1) and the chain over a world-size-1
     NCCL group (per merge an apply-and-pick launch, an all_reduce(MAX)
     of the pick key, a merge launch and an all_reduce of dl | dr):
     seeded random corpora at vocab 5120 and 8192 (an unk byte, 'aaaa'
     runs, a min_pair_freq stop) and the int16-crossing resume of
     tests/test_giant_64k_envelope.py (merges 32510-32524, ids past
     32767), then the chain in 2 gloo ranks on cuda:0 at vocab 1024 (each
     on its row shard and column block; merges == the single-device hist
     engine): records, tokens, the row shard, the bounds and the presence
     identical; then the first 128 merges on the bench layout at vocab
     32768 in each form: device ms per merge (enqueued behind a spin
     kernel), whole-loop ms per merge, launches per call, the plain
     version's, the mean chunks read per merge, the bound from what the
     merges move and the bound of the bytes the pass reads (counted in a
     rerun), and the chain's host enqueue and its two kernels' device µs
     under torch.profiler; then the main path
     BPETrainer(vocab, min_pair_freq 2, coverage 1.0, backend "cuda",
     mesh=<NCCL world 1>) load_corpus -> train -> save at 32768 (bytes ==
     phase 6's single-device giant output) and 65536 (bytes == the
     single-device flat engine's on the card, its first 32512 merges ==
     the 32768 run's): train() s, ms per merge, peak memory, merges done,
     one G1 launch per call; both runs again under torch.profiler (G1
     launches == the wrapper's count, busy share) and split into layers
     on the host clock; the sharded flat engine forced at the headline
     (bytes == the JAX golden digest, ms per merge); BPETrainer(shards=2)
     as 2 gloo ranks on cuda:0 at vocab 4608, min_pair_freq 50: bytes ==
     the single-device giant engine's
 16. (runs after phase 13) the GPT splitter: P1 (csrc/pretok.cu,
     pretok_ops.gpt_starts_mask) against its plain version on the card,
     on the seeded inputs of tests/torch_pretok_cases.py
     (tests/test_pretok_dfa.py's cases, fuzz strings, runs over 1024,
     lengths and runs of each class across the edges of the 16,384
     positions of a tile, runs longer than a tile), one position of each
     class, seeded classes a tile +- 1 long, and on the first 4,000,000
     and 1,000,000 characters of the corpus: masks identical, and the
     starts as byte offsets == the native scanner's
     (pretokenize.gpt_starts_bytes); the main path gpt_starts_device on
     the 4M text (P1 launched); P1's device ms per call (CUDA events
     around its two launches alone), launches per call and µs per
     launch (torch.profiler, in a fresh process: late in this one it
     drops events), the plain version's ms, the
     bound (a class byte in and a mask byte out per character);
     gpt_starts_device's MB/s and layers beside the native scanner's on
     the same bytes
 17. (runs after phase 14) the CLI, python -m shredword_tpu_torch, in
     subprocesses on the card: the wall-clock seconds of python alone,
     import torch, and info (the package's import), and, in a fresh
     process, of the CUDA context and the kernel and host libraries'
     loads; train at the headline (vocab 768, min_pair_freq 50,
     coverage 0.9999, unk -1) on the 16 MB corpus, bytes == the JAX
     golden digest: cold, then under SHREDWORD_TRACE (K1 launched,
     counted in the trace), then through the daemon
     (SHREDWORD_TORCH_DAEMON=1): its first call (which starts it) and
     two warm calls; encode of the first 1,000,000 characters == the
     Tokenizer's ids on the card, decode round-trips; train-unigram
     --vocab-size 1024 --seed-size 10000 == phase 14's pieces; the
     daemon is stopped at the end, also on failure

 18. (runs last) the port's bench, python -m shredword_tpu_torch.bench
     --corpus <this corpus>, in a fresh process on the card: exit 0, the
     last line bench.py's four keys (metric train_mb_s, value and
     vs_baseline above 0), the hist == giant == flat cross-check on its
     standard error; its standard error is echoed as [bench] lines, with
     the phase's seconds
 19. (runs after phase 6) the flat engine's loop F1 (csrc/flat.cu,
     _kernels.flat_train: one persistent launch per call) against its
     plain version (bpe_ops.train_loop) on the card, call by call in
     calls of 7 and 64 merges with a call past the end, on the seeded
     streams of tests/torch_flat_cases.py (words up to 1,000 tokens, a
     run of 1,001 'a's, unk bytes, ids past 65535, a min_pair_freq stop,
     words merged down to one token, a long tail of count-1 merges over
     4,001 words, late pairs held only by a chunk's first or last word, a
     resumed stream holding ids past 65535): records, the merge count,
     done and the compacted stream identical; then the first 128 merges
     on the 16 MB long-word corpus (bench.make_long_corpus, checked
     against its digest; its unique words and stream length printed) at
     vocab 32768, F1 and plain from the same arrays, timed (CUDA events),
     with the chunks its passes visit per merge and the bound of what the
     merges move (the plain version's pair counts before and after each
     merge); then the slice: BPETrainer(vocab 32768, min_pair_freq 2,
     coverage 1.0) load_corpus -> train -> save on that corpus, which
     routes to the flat engine (words over 64 bytes): one F1 launch per
     call of merges_per_device_call merges, the whole run's ms per merge
     (CUDA events around each call, its readback included) and chunks
     visited per merge, the final compaction and copy to the host timed
     apart, and the bytes equal to the plain flat engine's on the card
     over the whole run
 20. (runs after phase 19) BASELINE config 2: BPETrainer(vocab 32768,
     min_pair_freq 2000, coverage 1.0, the other arguments at their
     defaults) on the 1 GB Heaps-law corpus of bench.make_big_corpus
     (reused from the bench's directory when it is there with its known
     bytes, else generated; size and sha256 checked): load_corpus ->
     train -> save through the auto path, which must take the giant
     engine at chunk width 2048 and launch K3 (one launch per call);
     load_corpus, the int32 guard, _token_arrays, the layout, the upload,
     init_tables, K3's call loop (and K3's device time from CUDA events
     around each call), the final corpus and save on the host clock;
     merges beside the JAX package's 15,772, train() s, MB/s and peak
     device memory; then engine="flat" on the same corpus (F1 launched,
     one launch per call): .model/.vocab bytes == the auto path's; then
     K3 against its plain version for the first 128 merges on the auto
     path's layout (records, tokens, tables, presence and bounds
     identical) and F1 against its plain version for the first 128
     merges of the same stream, each timed with its bound

The long-word corpus is generated here too (make_long_corpus), and the
1 GB corpus (make_big_corpus, on every core).
The corpus is generated here (shredword_tpu_torch.bench.make_corpus, the
JAX bench's generator) and checked against its known digest.  The last lines of standard output are
the card's name and power limit, the kernels' JSON record and
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import multiprocessing
import os
import socket
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
              GIANT_VOCAB: "shredword_tpu/ops/bpe_giant.py:292",  # _giant_kernel
              "step": "shredword_tpu/ops/bpe_hist.py:262",  # _merge_kernel
              "sparse": "shredword_tpu/ops/bpe_hist.py:288",  # _merge_kernel_sparse
              "encode": "shredword_tpu/ops/encode_ops.py:230",  # _encode_core
              "unigram_fb": "shredword_tpu/ops/unigram_ops.py:70",  # _fb_core
              "unigram_viterbi":                    # _viterbi_device
              "shredword_tpu/ops/unigram_ops.py:329",
              "g1":                 # shard_body of build_sharded_giant_loop
              "shredword_tpu/parallel/giant.py:108",
              "gpt_starts":                         # gpt_starts_mask_jnp
              "shredword_tpu/ops/pretok_ops.py:313"}
TIMED_MERGES = 128
LATE_START = 16128   # the giant late window: new ids from 16384 on
# One H100 SXM (NVIDIA's data sheet): memory
# rate, and the float32 rate outside the tensor cores, taken as the rate
# of the int32 compares and adds these kernels do
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
RANK_TIMEOUT = 600
# the phases of csrc/hist_table.cuh's loop (hist_fused.cu, and hist_step.cu's
# sparse kernel) and of csrc/giant.cu, in the order of their enums; a "sync"
# phase is the wait in the grid barrier that ends the phase before it
HIST_PHASES = ["init", "init sync", "pick scan", "pick", "corpus",
               "corpus sync", "update rows", "update", "update sync"]
# csrc/hist_step.cu's chain, per launch (one merge each)
CHAIN_PHASES = ["apply rows", "apply", "apply sync", "pick", "corpus"]
GIANT_PHASES = ["init", "init sync", "pick scan", "row read", "row sync",
                "corpus", "corpus sync", "update rows", "update others",
                "update", "update sync", "bounds"]
# csrc/flat.cu's loop (F1); "init count" holds its barrier, "pass table"
# is the pass's last adds to the pair table
FLAT_PHASES = ["init count", "pick scan", "pick barrier", "pick reduce",
               "word pass", "pass table", "pass barrier"]
CLOCKED_BLOCKS, CLOCKED_PHASES = 1024, 16     # csrc/phase_clock.cuh
CARD = ""            # the card's name and power limit, read in phase 1


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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

def phase_env() -> tuple[str, str]:
    """Returns the card's name and power limit, and the path of the
    library built with the phase clocks."""
    from concurrent.futures import ThreadPoolExecutor

    from shredword_tpu_torch.ops import _kernels

    global CARD
    card = CARD = run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]).splitlines()[0]
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" torch CUDA {torch.version.cuda}")
    print(f"[env] {run([_kernels._nvcc(), '--version']).splitlines()[-1]}")
    clocked = _kernels.lib_path().replace("libshred_cuda-",
                                          "libshred_cuda_clocks-")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(_kernels.build, ("-Xptxas", "-v")),
                  pool.submit(_kernels.build, ("-DSHRED_PHASE_CLOCKS",),
                              clocked)]
        (path, out), _ = [b.result() for b in builds]
    print(f"[env] built {os.path.relpath(path, ROOT)} and "
          f"{os.path.relpath(clocked, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"[env] ptxas: {line.strip()}")
    return card, clocked


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


def run_both(kernel, plain, state, device, *, merges, steps, start=0,
             **kw):
    """Drive a kernel and its plain version call by call from merge
    `start`, each on its own state() (tensors updated in place), then one
    untimed call past the end (every step only confirms the pick);
    returns (max abs difference over records and state, kernel ms, plain
    ms, merges done)."""
    sk, sp = state(), state()
    err, ms_k, ms_p, n_done, done = 0, 0.0, 0.0, start, 0

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

    while n_done < start + merges and not done:
        allowed = start + merges - n_done
        recs = call(dict(kw, n_done=n_done, init_done=done, allowed=allowed,
                         steps=min(steps, allowed)))
        n_new = int(recs[:, 3].sum())
        done = int(n_new < min(steps, allowed))
        n_done += n_new
    call(dict(kw, n_done=n_done, init_done=1, allowed=0, steps=8),
         timed=False)
    return err, ms_k, ms_p, n_done - start


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
        L, W = bench_layout.tw.shape
        lim = min(v, 256 + n)
        # tw and the live table in and out, weights, records; a compare
        # per token per merge
        timing[v] = dict(max_abs_err=err, ms=ms_k / n, plain_ms=ms_p / n,
                         **bound((4 * L * W + 4 * W + 8 * lim * lim
                                  + 16 * n) / n, L * W),
                         library_ms=None)
        print(f"[kernel] bench layout {tuple(bench_layout.tw.shape)} v={v}:"
              f" first {n} merges, kernel {ms_k / n:.4f} ms/merge, plain "
              f"{ms_p / n:.4f} ms/merge, max |kernel - plain| = {err}")
    return timing


# ---------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------

def train_and_save(corpus, out_dir, vocab, device, engine="auto",
                   cfg=HEADLINE, tag="", **kw):
    from shredword_tpu_torch import BPETrainer

    t = BPETrainer(target_vocab_size=vocab, backend="cuda", device=device,
                   engine=engine, **cfg, **kw)
    cuda = device.type == "cuda"
    try:
        t.load_corpus(corpus)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        n = t.train()
        if cuda:
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        mp = os.path.join(out_dir, f"{engine}_{vocab}{tag}.model")
        vp = os.path.join(out_dir, f"{engine}_{vocab}{tag}.vocab")
        t.save(mp, vp)
        raw = t._arrays.total_raw_bytes
    finally:
        t.destroy()
    with open(mp, "rb") as f, open(vp, "rb") as g:
        return n, secs, raw, peak, f.read(), g.read()


def reset_counts() -> None:
    from shredword_tpu_torch.ops import _kernels

    from shredword_tpu_torch.ops import encode_ops, pretok_ops, unigram_ops

    for k in (_kernels.hist_fused_train, _kernels.giant_train_step,
              _kernels.hist_sharded_train, _kernels.hist_sparse_train,
              _kernels.giant_sharded_train, _kernels.flat_train,
              encode_ops.encode_core,
              unigram_ops.fb_core, unigram_ops.viterbi_core,
              pretok_ops.gpt_starts_mask):
        k.launches = 0


def phase_main_path(corpus, out_dir, vocab, device, *, engine="auto",
                    cfg=HEADLINE, kernel="hist_fused_train",
                    golden=None) -> tuple[int, bytes, bytes]:
    """Train, save and cross-check one configuration; returns the
    launches of `kernel` in the trainer's run (every count is set to 0
    just before it and read just after) and the .model/.vocab bytes."""
    from shredword_tpu_torch.ops import _kernels

    reset_counts()
    # CUDA events around each kernel call inside train(), no synchronise
    timer = Timed(getattr(_kernels, kernel), keep=True)
    setattr(_kernels, kernel, timer)
    try:
        n, secs, raw, peak, model, vocab_b = train_and_save(
            corpus, out_dir, vocab, device, engine, cfg)
    finally:
        setattr(_kernels, kernel, timer.fn)
    launches = getattr(_kernels, kernel).launches
    tag = f"[main] vocab {vocab}, engine {engine}"
    print(f"{tag}: {n} merges, train {secs:.4f} s, "
          f"{raw / 1e6 / secs:.3f} MB/s over {raw / 1e6:.2f} MB raw, "
          f"{launches} {kernel} calls, peak device memory "
          f"{peak / 1e9:.3f} GB")
    extra = (f", mean n_refresh {mean_refresh(timer.outs):.3f}"
             if kernel == "giant_train_step" else "")
    print(f"{tag}: merge loop {timer.ms() / n:.6f} ms per merge over the "
          f"whole run (CUDA events around its {len(timer.events)} kernel "
          f"calls){extra}")
    check(launches > 0, f"the main path launched {kernel}")
    check(n > 0, "merges learned")
    f1 = _kernels.flat_train.launches
    fn, fsecs, _, _, fmodel, fvocab = train_and_save(
        corpus, out_dir, vocab, device, "flat", cfg)
    f1 = _kernels.flat_train.launches - f1
    print(f"{tag}: flat engine {fn} merges in {fsecs:.4f} s ({f1} F1 "
          f"launches)")
    check(f1 > 0, "the flat engine ran F1")
    check(model == fmodel and vocab_b == fvocab,
          f"{engine} == flat .model/.vocab bytes at vocab {vocab}")
    if golden is not None:
        check(hashlib.sha256(model).hexdigest() == golden["model_sha256"]
              and hashlib.sha256(vocab_b).hexdigest()
              == golden["vocab_sha256"] and n == golden["merges"],
              "bytes equal the JAX package's golden digest")
        print(f"{tag}: .model/.vocab match the JAX golden digest "
              f"{golden['model_sha256'][:16]}...")
    return launches, model, vocab_b


# ---------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------

def nc_used(layout) -> int:
    cw = layout.tw.shape[1] // layout.presT.shape[1]
    return -(-layout.n_words // cw)


def run_giant_both(layout, v, device, *, unk, state=None, **kw):
    """run_both for the giant kernel; returns its result and the mean
    n_refresh (row reads per merge) of the kernel's merges."""
    from shredword_tpu_torch.ops import _kernels

    kernel = Timed(_kernels.giant_train_step, keep=True)
    out = run_both(kernel, _kernels.giant_train_step_plain,
                   state or (lambda: giant_state(layout, v, unk, device)),
                   device, unk=unk, nc_used=nc_used(layout), **kw)
    return (*out, mean_refresh(kernel.outs))


def mean_refresh(records: list[torch.Tensor]) -> float:
    """Mean n_refresh (lane 4) over the merges (did == 1) of giant
    records."""
    recs = torch.cat(records).cpu()
    did = recs[:, 3] == 1
    return float(recs[did, 4].double().mean())


def giant_cost(layout, state, start: int, n: int, cfg=GIANT) -> dict:
    """bound() per merge of the n giant merges from merge `start`, from
    what they must move on this run's data: once per call, the used
    chunks' tw in and out and their weights, and the live bounds in and
    out; per merge, the pick's row reads (n_refresh live rows), presence
    of a and b over the used chunks, every table cell and presence byte
    that the merge changes (read and written) and the record.  A compare
    per live bound and per cell read, for each row read.  The kernel
    advances `state` (at vocab GIANT_VOCAB) one merge per call, and what
    changed is found by comparing the state before and after.  The
    merges are those of ``cfg``'s unk_id and min_pair_freq."""
    from shredword_tpu_torch.ops import _kernels

    L, W = layout.tw.shape
    used = nc_used(layout)
    w_used = used * (W // layout.presT.shape[1])
    hist, presT = state[2], state[3]
    hist0, presT0 = hist.clone(), presT.clone()
    nbytes = 4 * L * w_used + 4 * w_used + 8 * (256 + start + n)
    ops = 0
    for i in range(n):
        lim = 257 + start + i                  # live ids of the merge
        rec = _kernels.giant_train_step(
            *state, unk=cfg["unk_id"], min_freq=cfg["min_pair_freq"],
            n_done=start + i, init_done=0, allowed=1, steps=1,
            nc_used=used)[0].tolist()
        check(rec[3] == 1, "the giant kernel merges through the window")
        cells = int((hist != hist0).sum())
        flags = int((presT != presT0).sum())
        nbytes += rec[4] * 4 * lim + 2 * used + 8 * cells + 2 * flags + 20
        ops += rec[4] * 2 * lim
        hist0.copy_(hist)
        presT0.copy_(presT)
    return bound(nbytes / n, ops / n)


def advance_giant(layout, device, merges: int) -> list[torch.Tensor]:
    """A giant state of the bench layout at vocab GIANT_VOCAB advanced
    by the kernel through `merges` merges, in calls of 4096 as
    giant_train makes them."""
    from shredword_tpu_torch.ops import _kernels

    st = giant_state(layout, GIANT_VOCAB, GIANT["unk_id"], device)
    n = 0
    while n < merges:
        steps = min(4096, merges - n)
        recs = _kernels.giant_train_step(
            *st, unk=GIANT["unk_id"], min_freq=GIANT["min_pair_freq"],
            n_done=n, init_done=0, allowed=merges - n, steps=steps,
            nc_used=nc_used(layout))
        n_new = int(recs[:, 3].sum())
        check(n_new == steps, "the giant kernel merges on to the window")
        n += n_new
    return st


def phase_giant_vs_plain(device: torch.device, bench_layout) -> dict:
    from shredword_tpu_torch.ops import bpe_giant

    for v, cw, min_freq, merges, steps in ((5120, 512, 2, 700, 128),
                                           (8192, 1024, 2, 900, 256),
                                           (8192, 2048, 2, 900, 256),
                                           (5120, 1024, 20000, 700, 64)):
        unk = 122                                       # the byte 'z'
        tokens, word_id, wc_word = random_corpus(v + cw, 30000, unk)
        layout = bpe_giant.build_giant_layout(tokens, word_id, wc_word, v,
                                              cw=cw)
        err, _, _, n, refresh = run_giant_both(
            layout, v, device, unk=unk, min_freq=min_freq, merges=merges,
            steps=steps)
        print(f"[giant] random corpus v={v} cw={cw} min_freq={min_freq}: "
              f"{n} merges in chunks of {steps}, mean n_refresh "
              f"{refresh:.3f}, max |kernel - plain| = {err}")
        check(err == 0 and (n == merges) == (min_freq == 2) and n > 0,
              f"giant kernel == plain at v={v} cw={cw}")
    gkw = dict(unk=GIANT["unk_id"], min_freq=GIANT["min_pair_freq"],
               merges=TIMED_MERGES, steps=TIMED_MERGES)
    err, ms_k, ms_p, n, refresh = run_giant_both(bench_layout, GIANT_VOCAB,
                                                 device, **gkw)
    check(err == 0 and n == TIMED_MERGES, f"bench layout v={GIANT_VOCAB}")
    cost = giant_cost(bench_layout, giant_state(
        bench_layout, GIANT_VOCAB, GIANT["unk_id"], device), 0, n)
    print(f"[giant] bench layout {tuple(bench_layout.tw.shape)} "
          f"v={GIANT_VOCAB}: first {n} merges, kernel {ms_k / n:.6f} "
          f"ms/merge (bound {cost['bound_ms']:.8f}, {cost['bound_by']}), "
          f"plain {ms_p / n:.4f} "
          f"ms/merge, mean n_refresh {refresh:.3f}, max |kernel - plain| "
          f"= {err}")
    # the late window: one state advanced by the kernel, then kernel and
    # plain from two clones of it, where lim is large
    base = advance_giant(bench_layout, device, LATE_START)
    err_l, ms_kl, ms_pl, n_l, refresh_l = run_giant_both(
        bench_layout, GIANT_VOCAB, device, start=LATE_START,
        state=lambda: [x.clone() for x in base], **gkw)
    check(err_l == 0 and n_l == TIMED_MERGES,
          f"late window from merge {LATE_START}")
    late = giant_cost(bench_layout, base, LATE_START, n_l)
    del base
    print(f"[giant] late window, merges {LATE_START}-{LATE_START + n_l}: "
          f"kernel {ms_kl / n_l:.6f} ms/merge (bound "
          f"{late['bound_ms']:.8f}, {late['bound_by']}), plain "
          f"{ms_pl / n_l:.4f} ms/merge, mean "
          f"n_refresh {refresh_l:.3f}, max |kernel - plain| = {err_l}")
    return dict(max_abs_err=max(err, err_l), ms=ms_k / n,
                plain_ms=ms_p / n, **cost, library_ms=None)

# ---------------------------------------------------------------------
# phases 8 and 9
# ---------------------------------------------------------------------

class Timed:
    """A function that records CUDA events around each call (no
    synchronisation inside the loop).  Where the host enqueues more slowly
    than the device runs, the device waits for the host between the
    events and their span is the host's time to enqueue the call; with
    ``lead`` cycles a spin kernel runs first, the call is enqueued while
    it spins, and the span is the device's time for the call alone (when
    the spin outlasts the enqueue: ``enqueue_ms`` is the host's time for
    each call)."""

    def __init__(self, fn, lead: int = 0, keep: bool = False):
        self.fn = fn
        self.lead = lead
        self.keep = keep
        self.events = []
        self.enqueue_ms = []
        self.outs = []       # what fn returned, when keep

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if self.lead:
            torch.cuda._sleep(self.lead)
        start.record()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        self.events.append((start, end))
        if self.keep:
            self.outs.append(out)
        return out

    # a kernel wrapper counts its launches on the module attribute it is
    # called through, which may be this object while it stands in for it
    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def ms(self, calls: int | None = None) -> float:
        """Device ms of the first `calls` calls (of all by default)."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[:calls])


class HostClock:
    """Host seconds of wrapped functions, summed per name; with sync the
    device is synchronized after each call and its wait is kept apart
    under "<name> wait"."""

    def __init__(self, device: torch.device):
        self.device = device
        self.secs: dict = {}

    def add(self, name: str, sec: float) -> None:
        self.secs[name] = self.secs.get(name, 0.0) + sec

    def wrap(self, name: str, fn, sync: bool = False):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            t1 = time.perf_counter()
            self.add(name, t1 - t0)
            if sync:
                torch.cuda.synchronize(self.device)
                self.add(name + " wait", time.perf_counter() - t1)
            return out
        wrapped.launches = 0    # a wrapper counts on the name it is under
        return wrapped


SPIN_CYCLES = {"sparse": 2_000_000,     # ~1 ms: one launch to enqueue
               "step": 60_000_000}      # ~30 ms: 130 launches, 128 reduces


def step_kernels(sparse: bool):
    """(name, wrapper, plain version, extra keywords) of K5 or of K4's
    chain; K4 reduces over the initialized process group, as sharded
    training does."""
    import torch.distributed as dist

    from shredword_tpu_torch.ops import _kernels

    if sparse:
        return ("sparse", _kernels.hist_sparse_train,
                _kernels.hist_sparse_train_plain, {})
    return ("step", _kernels.hist_sharded_train,
            _kernels.hist_sharded_train_plain, dict(reduce=dist.all_reduce))


def step_state(layout, v, unk, device, sparse: bool) -> list[torch.Tensor]:
    from shredword_tpu_torch.ops import bpe_hist

    st = hist_state(layout, v, unk, device)
    if sparse:
        st.append(torch.tensor(bpe_hist.build_presence(layout.tw, v),
                               device=device))
    return st


def step_cost(layout, v, device, *, sparse: bool, merges: int) -> dict:
    """bound() per merge of the first `merges` merges of K5 or K4 on the
    bench layout at vocab v, from what they move on this run's data,
    counted in a rerun of one merge per call: the corpus pass reads every
    token (K4) or the flagged chunks' tokens and the presence of a and b
    in every chunk (K5, which also writes three presence bytes per flagged
    chunk), and reads the weights and writes the tokens of the columns
    that hold the pair; the update reads and writes every table cell that
    changes; the record; K4 also writes dl | dr (int32 [2v]) for the
    all-reduce and reads it back.  The tables and presence before and
    after each merge show what changed.  A compare per token read."""
    from shredword_tpu_torch.ops import bpe_hist

    _, kernel, _, _ = step_kernels(sparse)
    st = step_state(layout, v, HEADLINE["unk_id"], device, sparse)
    tw, hist = st[0], st[2]
    L, W = tw.shape
    nc = W // bpe_hist.CHUNK
    matched = flagged = cells = 0
    for i in range(merges):
        tw0, hist0 = tw.clone(), hist.clone()
        pres0 = st[3].clone() if sparse else None
        rec = kernel(*st, unk=HEADLINE["unk_id"],
                     min_freq=HEADLINE["min_pair_freq"], n_done=i,
                     init_done=0, allowed=1, steps=1)[0].tolist()
        check(rec[3] == 1, "the step kernels merge through the window")
        a, b = rec[:2]
        matched += int(((tw0[:-1] == a) & (tw0[1:] == b)).any(0).sum())
        cells += int((hist != hist0).sum())
        if sparse:
            flagged += int(((pres0[a] != 0) & (pres0[b] != 0)).sum())
    mc, ch = matched / merges, flagged / merges
    nbytes = mc * (2 * L + 4) + 8 * cells / merges + 16
    if sparse:
        read = ch * L * bpe_hist.CHUNK
        nbytes += 2 * read + 2 * nc + 3 * ch
    else:
        read = L * W
        nbytes += 2 * read + 2 * 4 * 2 * v
    return dict(**bound(nbytes, read), matched=mc, flagged=ch,
                cells=cells / merges)


def phase_step_vs_plain(device, bench_layout, *, sparse: bool) -> dict:
    """K4's chain (sparse=False, over the world-size-1 NCCL group) or K5
    against its plain version, call by call; then timed over the first
    TIMED_MERGES merges on the bench layout at vocab 768 and 4096.
    Returns the JSON timing record at vocab 768."""
    from shredword_tpu_torch.ops import bpe_hist

    name, kernel, plain, extra = step_kernels(sparse)
    unk = 122                                           # the byte 'z'
    cases = [(768, 2, 300, 128), (4096, 2, 400, 96)]
    if sparse:
        cases.append((768, 50000, 300, 64))             # min_freq stop
    for v, min_freq, merges, steps in cases:
        tokens, word_id, wc_word = random_corpus(v + 7, 20000, unk)
        layout = bpe_hist.build_layout(tokens, word_id, wc_word, 64)
        calls = Timed(kernel, keep=True)
        n0 = kernel.launches
        err, _, _, n = run_both(
            lambda *st, **kw: calls(*st, **extra, **kw), plain,
            lambda: step_state(layout, v, unk, device, sparse), device,
            unk=unk, min_freq=min_freq, merges=merges, steps=steps)
        per_call = (kernel.launches - n0) / len(calls.events)
        print(f"[{name}] random corpus v={v} min_freq={min_freq}: {n} "
              f"merges in calls of {steps}, {per_call:.2f} launches per "
              f"call, max |kernel - plain| = {err}")
        check(err == 0 and 0 < n and (n == merges) == (min_freq == 2),
              f"{name} kernel == plain at v={v}")
    L, W = bench_layout.tw.shape
    kw = dict(unk=HEADLINE["unk_id"], min_freq=HEADLINE["min_pair_freq"])
    timing = {}
    for v in (768, 4096):
        def state(v=v):
            return step_state(bench_layout, v, kw["unk"], device, sparse)

        err, loop_k, ms_p, n = run_both(
            lambda *st, **ckw: kernel(*st, **extra, **ckw), plain, state,
            device, merges=TIMED_MERGES, steps=TIMED_MERGES, **kw)
        check(err == 0 and n == TIMED_MERGES, f"{name} bench layout v={v}")
        # the same merges again, the device kept ahead of the host
        td = Timed(kernel, lead=SPIN_CYCLES[name])
        n0 = kernel.launches
        td(*state(), n_done=0, init_done=0, allowed=n, steps=n, **extra,
           **kw)
        launches = kernel.launches - n0
        ms_k, enq = td.ms() / n, td.enqueue_ms[0]
        spin_ms = elapsed_ms(lambda: torch.cuda._sleep(SPIN_CYCLES[name]),
                             device)
        check(enq < spin_ms, f"{name}: the spin outlasts the enqueue")
        cost = step_cost(bench_layout, v, device, sparse=sparse, merges=n)
        extra_txt = f", {cost['matched']:.1f} columns matched"
        if sparse:
            extra_txt += f", {cost['flagged']:.2f} of {W // 512} chunks read"
        timing[v] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p / n,
                         bound_ms=cost["bound_ms"],
                         bound_by=cost["bound_by"], library_ms=None)
        print(f"[{name}] bench layout {(L, W)} v={v}: first {n} merges in "
              f"one call of {launches} launches; device {ms_k:.6f} ms/merge (enqueued in "
              f"{enq:.3f} ms under a {spin_ms:.3f} ms spin), whole loop "
              f"{loop_k / n:.6f} ms/merge, plain {ms_p / n:.4f} ms/merge; "
              f"bound {cost['bound_ms']:.8f} ms ({cost['bound_by']}"
              f"{extra_txt}, {cost['cells']:.1f} table cells changed per "
              f"merge); max |kernel - plain| = {err}")
    return timing[768]


# ---------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------

def busy_us(events) -> float:
    """Microseconds in which at least one of the device events ran."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def phase_profile(corpus, device) -> None:
    """One train() per main-path vocab, hist_train(sparse=True) and the
    sharded BPETrainer over the world-size-1 NCCL group at vocab 768,
    each under torch.profiler: the kernel launches per wrapper call (the
    persistent kernels: 1; K4's chain: its merges + 2) and the device
    busy share of the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shredword_tpu_torch import BPETrainer
    from shredword_tpu_torch.ops import _kernels, bpe_hist
    from shredword_tpu_torch.parallel import multihost

    arrays = token_arrays(corpus, device, HEADLINE)
    sparse_kw = dict(target_merges=768 - 256, unk_id=HEADLINE["unk_id"],
                     min_pair_freq=HEADLINE["min_pair_freq"], device=device,
                     lazy_final=True, sparse=True)
    # tag, configuration (None: hist_train(sparse=True)), trainer
    # keywords, wrapper, kernel name prefix
    runs = [("vocab 768", (768, HEADLINE), {}, "hist_fused_train",
             "hist_train_kernel"),
            ("vocab 4096", (4096, HEADLINE), {}, "hist_fused_train",
             "hist_train_kernel"),
            (f"vocab {GIANT_VOCAB}", (GIANT_VOCAB, GIANT), {},
             "giant_train_step", "giant_train_kernel"),
            ("hist_train(sparse=True) vocab 768", None, {},
             "hist_sparse_train", "sparse_train_kernel"),
            ("sharded NCCL world 1 vocab 768", (768, HEADLINE),
             dict(mesh=multihost.global_mesh()), "hist_sharded_train",
             "chain_")]
    for tag, cfg, tkw, wrapper, kernel in runs:
        fn = getattr(_kernels, wrapper)
        calls = Timed(fn)
        t = None
        if cfg is not None:
            vocab, conf = cfg
            t = BPETrainer(target_vocab_size=vocab, backend="cuda",
                           device=device, **conf, **tkw)
        try:
            if t is not None:
                t.load_corpus(corpus)
            torch.cuda.synchronize(device)
            n0 = fn.launches
            setattr(_kernels, wrapper, calls)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if t is None:
                    merges = len(bpe_hist.hist_train(*arrays,
                                                     **sparse_kw)[0])
                else:
                    merges = t.train()
                torch.cuda.synchronize(device)
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            setattr(_kernels, wrapper, fn)
            if t is not None:
                t.destroy()
        launches, n_calls = fn.launches - n0, len(calls.events)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ours = [e for e in dev if kernel in e.name]
        print(f"[profile] {tag}: {merges} merges, {len(ours)} {kernel}* "
              f"launches in {n_calls} {wrapper} calls "
              f"({len(ours) / max(n_calls, 1):.2f} per call), "
              f"{len(dev)} device events, device busy "
              f"{busy_us(dev) / wall_us:.3f} of the run "
              f"({wall_us / 1e3:.2f} ms under the profiler), "
              f"{kernel}* {busy_us(ours) / 1e3:.2f} ms")
        check(len(dev) > 0, f"the profiler saw device events, {tag}")
        chain = wrapper == "hist_sharded_train"
        want = merges + 2 * n_calls if chain else n_calls
        check(len(ours) == launches == want > 0,
              f"{tag}: " + ("merges + 2 launches of the chain per call"
                            if chain else "one kernel launch per call"))


# ---------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------

def phase_sparse_train(corpus, device) -> int:
    """hist_train(sparse=True) at the headline configuration; returns the
    K5 kernel's launches in that run (every count is set to 0 just before
    it and read just after)."""
    from shredword_tpu_torch.ops import _kernels, bpe_hist

    tokens, word_id, wc_word = token_arrays(corpus, device, HEADLINE)
    kw = dict(target_merges=768 - 256, unk_id=HEADLINE["unk_id"],
              min_pair_freq=HEADLINE["min_pair_freq"], device=device,
              lazy_final=True)
    timer = Timed(_kernels.hist_sparse_train)
    reset_counts()
    torch.cuda.synchronize(device)
    _kernels.hist_sparse_train = timer
    try:
        t0 = time.perf_counter()
        sm, sf, _ = bpe_hist.hist_train(tokens, word_id, wc_word,
                                        sparse=True, **kw)
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
    finally:
        _kernels.hist_sparse_train = timer.fn
    launches = _kernels.hist_sparse_train.launches
    dm, df, _ = bpe_hist.hist_train(tokens, word_id, wc_word, **kw)
    print(f"[sparse] hist_train(sparse=True) vocab 768: {len(sm)} merges in "
          f"{secs:.4f} s, {launches} hist_sparse_train launches in "
          f"{len(timer.events)} calls, merge loop "
          f"{timer.ms() / len(sm):.6f} ms per merge over the whole run "
          f"(CUDA events around each call)")
    check(launches > 0, "the sparse path launched hist_sparse_train")
    check(len(sm) == 512 and np.array_equal(sm, dm)
          and np.array_equal(sf, df), "sparse == dense merges and freqs")
    return launches


# ---------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def first_collective(device: torch.device) -> float:
    """Seconds of the process group's first all_reduce: the
    communicator's set-up (lazy in NCCL), kept out of train()."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=device))
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def sharded_rank(rank, world, store, corpus, vocab, out_dir, result, dev):
    """One gloo rank of BPETrainer(shards=world) on device `dev`
    (spawned)."""
    import torch.distributed as dist

    from shredword_tpu_torch.ops import _kernels

    device = torch.device(dev)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        setup = first_collective(device)
        reset_counts()
        n, secs, raw, _, model, vocab_b = train_and_save(
            corpus, out_dir, vocab, device, tag=f"_gloo{world}r{rank}",
            shards=world)
        launches = _kernels.hist_sharded_train.launches
        g1_launches = _kernels.giant_sharded_train.launches
    finally:
        dist.destroy_process_group()
    with open(result, "w") as f:
        json.dump(dict(n=n, secs=secs, raw=raw, launches=launches,
                       g1_launches=g1_launches, setup=setup,
                       model=hashlib.sha256(model).hexdigest(),
                       vocab=hashlib.sha256(vocab_b).hexdigest()), f)


def run_gloo_ranks(corpus, out_dir, vocab, device, world=2) -> list[dict]:
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, f"store_{vocab}")
    results = [os.path.join(out_dir, f"rank{r}_{vocab}.json")
               for r in range(world)]
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, world, store, corpus, vocab, out_dir,
                               results[r], str(device)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"gloo ranks exited with {codes}")
    out = []
    for path in results:
        with open(path) as f:
            out.append(json.load(f))
    return out


def phase_sharded(corpus, out_dir, device, golden, fused_4096,
                  setup: float) -> int:
    """Sharded BPETrainer through the public API over the initialized
    world-size-1 NCCL group (its first all_reduce took `setup` s), then
    in 2 spawned gloo ranks; returns the K4 chain's launches in the NCCL
    run at the headline."""
    from shredword_tpu_torch.ops import _kernels
    from shredword_tpu_torch.parallel import multihost

    timer = Timed(_kernels.hist_sharded_train)
    reset_counts()
    _kernels.hist_sharded_train = timer
    try:
        n, secs, raw, _, model, vocab_b = train_and_save(
            corpus, out_dir, 768, device, tag="_nccl1",
            mesh=multihost.global_mesh())
    finally:
        _kernels.hist_sharded_train = timer.fn
    launches = _kernels.hist_sharded_train.launches
    print(f"[sharded] nccl world 1, vocab 768: first all_reduce "
          f"{setup:.4f} s, then {n} merges, train {secs:.4f} s, "
          f"{raw / 1e6 / secs:.3f} MB/s, {launches} hist_sharded_train "
          f"launches in {len(timer.events)} calls, merge loop "
          f"{timer.ms() / n:.6f} ms per merge over the whole run (CUDA "
          f"events around each call; the host enqueues the chain)")
    check(launches > 0, "sharded training launched hist_sharded_train")
    check(hashlib.sha256(model).hexdigest() == golden["model_sha256"]
          and hashlib.sha256(vocab_b).hexdigest() == golden["vocab_sha256"]
          and n == golden["merges"], "NCCL world 1 == JAX golden digest")
    want = {768: (golden["model_sha256"], golden["vocab_sha256"]),
            4096: tuple(hashlib.sha256(b).hexdigest() for b in fused_4096)}
    for vocab in (768, 4096):
        ranks = run_gloo_ranks(corpus, out_dir, vocab, device)
        for r, res in enumerate(ranks):
            print(f"[sharded] gloo rank {r}/2 on {device}, vocab {vocab}: "
                  f"first all_reduce {res['setup']:.4f} s, then "
                  f"{res['n']} merges, train {res['secs']:.4f} s, "
                  f"{res['raw'] / 1e6 / res['secs']:.3f} MB/s, "
                  f"{res['launches']} hist_sharded_train launches")
            check(res["launches"] > 0 and (res["model"], res["vocab"])
                  == want[vocab], f"2 gloo ranks, vocab {vocab}: bytes")
        print(f"[sharded] 2 gloo ranks, vocab {vocab}: bytes equal the "
              + ("JAX golden digest" if vocab == 768
                 else "fused hist engine's"))
    return launches


# ---------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------

def read_cycles(lib, name: str) -> np.ndarray:
    """[blocks, phases] SM cycles of every block that ran since the last
    read (the counts are then zeroed)."""
    torch.cuda.synchronize()
    buf = np.zeros((CLOCKED_BLOCKS, CLOCKED_PHASES), np.uint64)
    check(getattr(lib, name)(buf.ctypes.data) == 0, f"{name} read")
    ran = np.flatnonzero(buf.sum(1) > 0)
    return buf[:ran.max() + 1 if len(ran) else 0].astype(np.float64)


def drive(kernel, state, merges: int, steps: int, **kw):
    """Call kernel on state in calls of `steps` from merge 0 up to
    `merges`, as the trainer does; returns (records, device ms of the
    calls)."""
    n, ms, recs = 0, 0.0, []
    while n < merges:
        st = min(steps, merges - n)
        ms += elapsed_ms(lambda: recs.append(kernel(
            *state, n_done=n, init_done=0, allowed=merges - n, steps=st,
            **kw)), state[0].device)
        done = int(recs[-1][:, 3].sum())
        n += done
        if done < st:
            break
    return torch.cat(recs), ms


def phase_clocks(device, clocked: str, hist_layout, giant_layout,
                 long_arrays) -> None:
    """The build with phase clocks against the plain build, on the main
    path's kernel calls from equal states (records and state identical),
    and where each merge's time goes: per phase, the µs per merge of the
    mean block and of the largest, SM cycles at the clock rate implied by
    block 0's cycles over the clocked calls' device time.  The clocked
    build synchronises each block at every mark, so its time differs a
    little from the plain build's."""
    from shredword_tpu_torch.ops import _kernels

    lib = _kernels.bind(clocked)
    for name in ("shred_hist_phase_cycles", "shred_giant_phase_cycles",
                 "shred_step_phase_cycles"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    plain = _kernels.lib()
    hkw = dict(unk=HEADLINE["unk_id"], min_freq=HEADLINE["min_pair_freq"])
    gkw = dict(unk=GIANT["unk_id"], min_freq=GIANT["min_pair_freq"],
               nc_used=nc_used(giant_layout))
    hist = ("hist_fused_train", "shred_hist_phase_cycles", HIST_PHASES, hkw)
    giant = ("giant_train_step", "shred_giant_phase_cycles", GIANT_PHASES,
             gkw)
    sparse = ("hist_sparse_train", "shred_step_phase_cycles", HIST_PHASES,
              hkw)
    chain = ("hist_sharded_train", "shred_step_phase_cycles", CHAIN_PHASES,
             hkw)
    cases = [(f"hist v {v}", hist, v - 256, 512,
              lambda v=v: hist_state(hist_layout, v, hkw["unk"], device))
             for v in (768, 4096)]
    cases += [(f"{what} v 768", kernel, 512, 512,
               lambda sp=sp: step_state(hist_layout, 768, hkw["unk"], device,
                                        sp))
              for what, kernel, sp in (("sparse", sparse, True),
                                       ("chain", chain, False))]
    cases += [(f"giant v {GIANT_VOCAB} {what}", giant, merges, steps,
               lambda: giant_state(giant_layout, GIANT_VOCAB, gkw["unk"],
                                   device))
              for what, merges, steps in (
                  (f"first {TIMED_MERGES}", TIMED_MERGES, TIMED_MERGES),
                  ("whole run", GIANT_VOCAB - 256, 4096))]
    for tag, (wrapper, reader, names, kw), merges, steps, state in cases:
        kernel = getattr(_kernels, wrapper)
        sp = state()
        recs_p, _ = drive(kernel, sp, merges, steps, **kw)
        sc = state()
        read_cycles(lib, reader)
        _kernels._lib = lib
        try:
            recs_c, ms = drive(kernel, sc, merges, steps, **kw)
        finally:
            _kernels._lib = plain
        cycles = read_cycles(lib, reader)
        err = max(max_abs_diff(a, b)
                  for a, b in [(recs_c, recs_p), *zip(sc, sp)])
        del sp, sc
        n = int(recs_c[:, 3].sum())
        check(err == 0 and n == merges,
              f"the phase-clock build equals the plain build, {tag}")
        if wrapper != "hist_sharded_train":
            per_us = cycles[0].sum() / (ms * 1e3)      # cycles per µs
        # else the chain's host gaps lie between its launches: the clock
        # rate of the persistent kernel before it
        print(f"[clocks] {tag}: {n} merges, clocked kernel {ms / n:.6f} ms "
              f"per merge, {len(cycles)} blocks at {per_us / 1e3:.3f} GHz, "
              f"records and state equal the plain build's")
        print_split(tag, cycles / per_us / n, names)
    flat_clocks(device, lib, long_arrays)


def print_split(tag: str, us: np.ndarray, names: list[str]) -> None:
    """µs per merge of each phase, [blocks, phases]: the mean block's and
    the largest."""
    for k, name in enumerate(names):
        print(f"[clocks] {tag}:   {name:<13} mean {us[:, k].mean():7.4f},"
              f" largest block {us[:, k].max():7.4f} µs per merge")


def flat_outcome(ts) -> list[torch.Tensor]:
    """What a flat run leaves, in a form that does not depend on where
    F1's blocks inserted keys: the records, the merge count and done, the
    words and their live lengths, the (key, count) pairs of the table
    sorted by key, F1's state words, the presence index and the word
    signatures."""
    fs = ts.corpus
    used = fs.tkey != -1
    key, order = torch.sort(fs.tkey[used])
    return [torch.from_numpy(ts.merges), torch.from_numpy(ts.merge_freqs),
            torch.tensor([ts.n_merges, int(ts.done)]), fs.tokens, fs.len,
            key, fs.cnt[used][order], fs.st, fs.pres, fs.sig]


def flat_clocks(device, lib, arrays) -> None:
    """F1's clocked build against its plain build on the long-word corpus
    at vocab 32768 (the first 128 merges, then the whole run in calls of
    64, as the trainer calls it), and the split of a merge by phase."""
    from shredword_tpu_torch.ops import _kernels

    lib.shred_flat_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.shred_flat_phase_cycles.restype = ctypes.c_int
    plain = _kernels.lib()
    for what, merges, steps in ((f"first {TIMED_MERGES}", TIMED_MERGES,
                                 TIMED_MERGES),
                                ("whole run", GIANT_VOCAB - 256, 64)):
        tag = f"flat v {GIANT_VOCAB} {what}"
        runs = []
        for build in (plain, lib):
            read_cycles(lib, "shred_flat_phase_cycles")
            ts, _ = flat_states(arrays, device, merges)
            _kernels._lib = build
            ms = 0.0
            try:
                while not ts.done and ts.n_merges < merges:
                    out = {}
                    ms += elapsed_ms(lambda: out.__setitem__(
                        "ts", _kernels.flat_train(
                            ts, GIANT["unk_id"], GIANT["min_pair_freq"],
                            target_merges=merges, max_steps=steps)), device)
                    ts = out["ts"]
            finally:
                _kernels._lib = plain
            runs.append((ts, ms))
        cycles = read_cycles(lib, "shred_flat_phase_cycles")
        (tp, _), (tc, ms) = runs
        err = max(max_abs_diff(a.to(device), b.to(device))
                  if a.shape == b.shape else F1_TOO_FAR
                  for a, b in zip(flat_outcome(tc), flat_outcome(tp)))
        n = tc.n_merges
        check(err == 0 and n == merges,
              f"the phase-clock build equals the plain build, {tag}")
        per_us = cycles[0].sum() / (ms * 1e3)
        print(f"[clocks] {tag}: {n} merges, clocked kernel {ms / n:.6f} ms "
              f"per merge, {len(cycles)} blocks at {per_us / 1e3:.3f} GHz, "
              f"records and state equal the plain build's; the passes "
              f"visit {tc.corpus.visited / n:.2f} of "
              f"{-(-tc.corpus.n_words // 32)} chunks per merge and merge "
              f"{tc.corpus.candidates / n:.2f} words whose signature "
              f"holds the pair, the picks recompute "
              f"{tc.corpus.refreshed / n:.2f} segment maxima")
        print_split(tag, cycles / per_us / n, FLAT_PHASES)


# ---------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------

ENCODE_CHARS = 4_000_000     # the JAX bench's encode text (bench.py:255)
GPT_CHARS = 1_000_000
DOC_CHARS = 65536            # encode_batch_arrays' documents (bench.py:270)
KERNEL_REPS = 20
FHUS = np.array([[117, 115], [104, 256], [102, 104]], np.int32)


def merges_of(model: bytes) -> np.ndarray:
    """The merges of a binary .model (int32 triples a, b, 256 + m)."""
    return np.frombuffer(model, "<i4").reshape(-1, 3)[:, :2].copy()


def encode_table(merges: np.ndarray, v: int, device):
    from shredword_tpu_torch.ops import encode_ops

    if v <= encode_ops.DENSE_V_MAX:
        return encode_ops.build_rank_table(merges, v, device)
    return encode_ops.build_merge_table(merges, device)


def corpus_chunks(text: bytes, seed: int, n: int, n_long: int):
    """(flat uint8, lens int32) of seeded slices of the corpus text: n of
    1..64 bytes, then n_long of 65..300; 'aaaa' runs, and a byte no merge
    names (0xff) in every 50th chunk."""
    rng = np.random.RandomState(seed)
    lens = np.concatenate([rng.randint(1, 65, n), rng.randint(65, 301,
                                                              n_long)])
    at = rng.randint(0, len(text) - 301, len(lens))
    parts = [bytearray(text[a:a + n]) for a, n in zip(at, lens)]
    for i, part in enumerate(parts):
        if i < 20:
            part[:] = b"a" * len(part)
        elif i % 50 == 0:
            part[len(part) // 2] = 0xFF
    return (np.frombuffer(b"".join(parts), np.uint8).copy(),
            lens.astype(np.int32))


def encode_both(flat, lens, table, v, device, plain):
    """(max |kernel - plain| over ids and counts, -1 if their shapes
    differ; n ids) of encode_core on the card and `plain` on the same
    card tensors."""
    from shredword_tpu_torch.ops import encode_ops

    df = torch.from_numpy(flat).to(device)
    dl = torch.from_numpy(lens).to(device)
    ik, ck = encode_ops.encode_core(df, dl, table, v=v)
    ip, cp = plain(df, dl, table, v)
    if ik.shape != ip.shape or ck.shape != cp.shape:
        return -1, len(ik)
    return max(max_abs_diff(ik, ip), max_abs_diff(ck, cp)), len(ik)


def phase_encode_vs_plain(device, text: bytes, merges: dict) -> None:
    """csrc/encode.cu against its two plain versions on the card, on
    seeded corpus slices (chunks of at most 64 bytes against
    encode_core_plain; with chunks of 65-300 bytes against
    encode_flat_plain) at each vocab's table, on the edges of its length
    classes (tests/torch_encode_cases.py, dense and hash tables), and on
    'fhus'."""
    from shredword_tpu_torch.ops import encode_ops

    for v, m in merges.items():
        table = encode_table(m, v, device)
        for tag, (n, n_long), name, plain in (
                ("chunks of 1-64 bytes", (20000, 0), "encode_core_plain",
                 encode_ops.encode_core_plain),
                ("with 30 chunks of 65-300 bytes", (3000, 30),
                 "encode_flat_plain", encode_ops._flat_plain_counts)):
            flat, lens = corpus_chunks(text, v + n_long, n, n_long)
            err, n_ids = encode_both(flat, lens, table, v, device, plain)
            print(f"[encode] v={v} {'dense' if v <= 4096 else 'hash'} "
                  f"table, {len(lens)} {tag}: {len(flat)} bytes -> {n_ids} "
                  f"ids, max |kernel - {name}| = {err}")
            check(err == 0 and n_ids < len(flat),
                  f"encode kernel == {name} at v={v}")
    from torch_encode_cases import boundary_cases

    for name, (flat, lens, m) in boundary_cases().items():
        v = 256 + len(m)
        short = lens <= encode_ops.MAX_TW_LEN
        starts = np.cumsum(lens) - lens
        sflat = np.concatenate([flat[a:a + n] for a, n, k
                                in zip(starts, lens, short) if k])
        for table in (encode_ops.build_rank_table(m, v, device),
                      encode_ops.build_merge_table(m, device)):
            kind = "dense" if isinstance(table, torch.Tensor) else "hash"
            err, _ = encode_both(sflat, lens[short].astype(np.int32), table,
                                 v, device, encode_ops.encode_core_plain)
            err_l, n_ids = encode_both(flat, lens.astype(np.int32), table, v,
                                       device, encode_ops._flat_plain_counts)
            print(f"[encode] length-class edges '{name}' ({kind} table): "
                  f"{len(lens)} chunks, {len(flat)} bytes -> {n_ids} ids; "
                  f"max |kernel - encode_core_plain| = {err} (chunks <= 64 "
                  f"bytes), max |kernel - encode_flat_plain| = {err_l}")
            check(err == 0 and err_l == 0,
                  f"encode kernel == plain on the '{name}' edges, {kind}")
    for table in (encode_table(FHUS, 259, device),
                  encode_ops.build_merge_table(FHUS, device)):
        ids, _ = encode_ops.encode_core(
            torch.tensor(list(b"fhus"), dtype=torch.uint8, device=device),
            torch.tensor([4], dtype=torch.int32, device=device), table, v=259)
        check(encode_ops.ids_to_numpy(ids).tolist() == [102, 257],
              "'fhus' -> [102, 257] (a created pair preempts)")


def best_mbs(fn, nbytes: int, trials: int = 3) -> float:
    """Best MB/s of `trials` calls of fn (each returns host data, so it
    ends with the device's work done)."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return nbytes / 1e6 / best


def encode_kernel_ms(df, dl, table, v: int, device) -> tuple[float, ...]:
    """Device ms per call of csrc/encode.cu's two launches alone on these
    inputs, and of each launch alone (merge, pack): KERNEL_REPS
    back-to-back calls between two CUDA events, launched through the
    library directly (uncounted), the buffers and the output offsets
    prepared once (the bench's encode_launch_ms)."""
    from shredword_tpu_torch.bench import encode_launch_ms

    return encode_launch_ms(df, dl, table, v, device, KERNEL_REPS)


def encode_kernel_cost(df, lens: np.ndarray, table, v: int, device):
    """The kernel on the chunks `lens` of the bytes df: (its ms per call,
    its plain version's ms, max |kernel - plain|, its rank lookups, the
    bound from the bytes it moves and the lookups it makes, the plain
    version, the ms of its merge and pack launches each alone)."""
    from shredword_tpu_torch.ops import encode_ops

    dl = torch.from_numpy(lens.astype(np.int32)).to(device)
    ms, *split = encode_kernel_ms(df, dl, table, v, device)
    plain = (encode_ops.encode_core_plain
             if int(lens.max()) <= encode_ops.MAX_TW_LEN
             else encode_ops._flat_plain_counts)
    plain(df, dl, table, v)                                    # warm-up
    out = {}
    plain_ms = elapsed_ms(lambda: out.__setitem__(
        "p", plain(df, dl, table, v)), device)
    ik, ck = encode_ops.encode_core(df, dl, table, v=v)
    err = max(max_abs_diff(ik, out["p"][0]), max_abs_diff(ck, out["p"][1]))
    check(err == 0, f"kernel == plain on {len(lens)} chunks, v={v}")
    lookups = torch.zeros(1, dtype=torch.int64, device=device)
    encode_ops.encode_core(df, dl, table, v=v, lookups=lookups)
    n_look = int(lookups)
    # the bytes in; per chunk its length, offset and count; the ids out;
    # each rank lookup reads one int32 (dense) or one probe of three
    # (hash; at least one probe each); a compare per lookup
    per_look = 4 if v <= encode_ops.DENSE_V_MAX else 12
    cost = bound(int(lens.sum()) + 16 * len(lens) + ik.element_size()
                 * len(ik) + per_look * n_look, n_look)
    return ms, plain_ms, err, n_look, cost, plain, split


def encode_profile(tok, text: str, device) -> tuple[float, float]:
    """(encode_core kernel launches per encode_array call, device busy
    share of the call) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok.encode_array(text)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in dev if "encode_kernel" in e.name
            or "pack_kernel" in e.name]
    check(len(dev) > 0, "the profiler saw device events, encode")
    return len(ours), busy_us(dev) / wall_us


def best_ms(fn, trials: int = 3):
    """(best ms of `trials` calls of fn, its last result)."""
    best, out = float("inf"), None
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def gather_spans(flat: np.ndarray, off: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
    """The spans flat[off[i]:off[i] + lens[i]] concatenated."""
    new_off = np.cumsum(lens) - lens
    return flat[np.repeat(off - new_off, lens)
                + np.arange(int(lens.sum()), dtype=np.int64)]


def expand_ids(ids_u, cnt_u, inverse) -> np.ndarray:
    """Every chunk's ids from each distinct chunk's (native memcpy)."""
    from shredword_tpu_torch.runtime import native

    uoff = np.zeros(len(cnt_u) + 1, np.int64)
    np.cumsum(cnt_u, out=uoff[1:])
    return native.expand_ids(ids_u, uoff, inverse, int(cnt_u[inverse].sum()))


def encode_routes(text: str, merges: np.ndarray, v: int, device) -> list:
    """Whitespace-keep and GPT chunks of `text` encoded two ways, each
    layer timed alone (best of 3) and the ids checked equal to the
    native CPU encoder's: directly (the chunk lengths, then one device
    call over every chunk: upload, E1's two launches, downloads) and
    through the distinct chunks (a native dedup pass, the gather of the
    distinct chunks, one device call over them, the native expansion to
    every chunk).  The GPT scanner's offsets are common to both routes
    and not timed.  Returns the lines to print."""
    from shredword_tpu_torch import Tokenizer, pretokenize
    from shredword_tpu_torch.ops import encode_ops
    from shredword_tpu_torch.runtime import native

    data = text.encode()
    flat = np.frombuffer(data, np.uint8)
    table = encode_ops._get_table(merges, v, {}, device)
    g_lens = np.diff(np.append(pretokenize.gpt_starts_bytes(data),
                               len(data)))
    g_off = np.cumsum(g_lens) - g_lens

    def g_dedup():
        inverse, uniq = native.dedup_spans(flat, g_off, g_lens)
        return inverse, g_off[uniq], g_lens[uniq]

    lines = []
    for name, chunk, dedup, pattern in (
            ("whitespace", lambda: encode_ops.ws_chunk_lens(flat),
             lambda: native.ws_chunk_dedup(flat), ""),
            ("gpt", lambda: g_lens, g_dedup, "gpt")):
        want = Tokenizer(merges, pattern=pattern,
                         backend="cpu").encode_array(text)
        t_chunk, lens = best_ms(chunk)
        t_dev, (ids, _) = best_ms(lambda: encode_ops._encode_contiguous(
            flat, lens, table, v, device))
        t_dedup, (inverse, uoff, ulen) = best_ms(dedup)
        lens_u = ulen.astype(np.int64)
        t_gather, sub = best_ms(lambda: gather_spans(flat, uoff, lens_u))
        t_dev_u, (ids_u, cnt_u) = best_ms(
            lambda: encode_ops._encode_contiguous(sub, lens_u, table, v,
                                                  device))
        t_expand, ids_d = best_ms(lambda: expand_ids(ids_u, cnt_u, inverse))
        check(np.array_equal(ids, want) and np.array_equal(ids_d, want),
              f"both encode routes == native cpu ids, {name}, v={v}")
        if name == "gpt":
            t_chunk = 0.0
        lines.append(
            f"{name} chunks of {len(data)} bytes: direct "
            f"{t_chunk + t_dev:.3f} ms (chunk lengths {t_chunk:.3f}, device "
            f"call over {len(lens)} chunks {t_dev:.3f}); through the "
            f"distinct chunks {t_dedup + t_gather + t_dev_u + t_expand:.3f} "
            f"ms (dedup {t_dedup:.3f}, gather {t_gather:.3f}, device call "
            f"over {len(lens_u)} chunks {t_dev_u:.3f}, expand "
            f"{t_expand:.3f})")
    return lines


def phase_encode_main(device, text: str, merges: np.ndarray, v: int) -> dict:
    """The encode main path at vocab v, as bench.py:247-283 runs it, and
    its measurements; returns the kernels-line record."""
    from shredword_tpu_torch import Tokenizer, pretokenize
    from shredword_tpu_torch.ops import encode_ops
    from shredword_tpu_torch.runtime import native

    tag = f"[encode] v={v}"
    data = text.encode()
    nbytes = len(data)
    tok = Tokenizer(merges, backend="cuda", device=device)
    cpu = Tokenizer(merges, backend="cpu")
    reset_counts()
    t0 = time.perf_counter()
    ids = tok.encode_array(text)
    first_s = time.perf_counter() - t0
    launches = encode_ops.encode_core.launches
    want = cpu.encode_array(text)
    check(launches > 0, f"the encode main path launched encode.cu, v={v}")
    check(np.array_equal(ids, want), f"cuda ids == native cpu ids, v={v}")
    check(tok.decode(ids) == text, f"decode round-trips, v={v}")
    enc = best_mbs(lambda: tok.encode_array(text), nbytes)
    cpu_mbs = best_mbs(lambda: cpu.encode_array(text), nbytes)
    dec = best_mbs(lambda: tok.decode(ids), nbytes)
    docs = [text[i:i + DOC_CHARS] for i in range(0, len(text), DOC_CHARS)]
    batch = tok.encode_batch_arrays(docs)
    check(all(np.array_equal(b, tok.encode_array(d))
              for b, d in zip(batch, docs)),
          f"encode_batch_arrays == per document, v={v}")
    batch_mbs = best_mbs(lambda: tok.encode_batch_arrays(docs), nbytes)
    gtext = text[:GPT_CHARS]
    gpt = Tokenizer(merges, pattern="gpt", device=device)
    gids = gpt.encode_array(gtext)
    check(np.array_equal(gids, Tokenizer(merges, pattern="gpt",
                                         backend="cpu").encode_array(gtext))
          and gpt.decode(gids) == gtext, f"gpt pattern == cpu ids, v={v}")
    per_call, busy = encode_profile(tok, text, device)
    check(per_call == 2, f"two encode.cu launches per encode_array, v={v}")
    routes = [line for n in (DOC_CHARS, len(text))
              for line in encode_routes(text[:n], merges, v, device)]

    # the kernel alone on the main path's call (every whitespace chunk of
    # the text), and on the GPT chunks of the same text
    flat = np.frombuffer(data, np.uint8)
    lens = encode_ops.ws_chunk_lens(flat)
    _, _, ulen = native.ws_chunk_dedup(flat)
    table = encode_table(merges, v, device)
    df = torch.from_numpy(flat.copy()).to(device)
    ms, plain_ms, err, n_look, cost, plain, split = encode_kernel_cost(
        df, lens, table, v, device)
    g_lens = np.diff(np.append(pretokenize.gpt_starts_bytes(data), nbytes))
    g_ms, _, g_err, g_look, g_cost, _, g_split = encode_kernel_cost(
        df, g_lens, table, v, device)
    W = len(lens)
    print(f"{tag}: {nbytes} bytes, {W} chunks ({len(ulen)} distinct, "
          f"{int(ulen.sum())} bytes) -> {len(ids)} ids; encode "
          f"{enc:.3f} MB/s (native cpu {cpu_mbs:.3f}), encode_batch_arrays "
          f"of {len(docs)} documents {batch_mbs:.3f} MB/s, decode "
          f"{dec:.3f} MB/s (best of 3 after a warm-up); {launches} "
          f"encode.cu launches in the first call ({first_s:.4f} s with the "
          f"rank table's build), {per_call} per call (profiler), device "
          f"busy {busy:.4f} of the call")
    for line in routes:
        print(f"{tag}: {line}")
    print(f"{tag}: kernel {ms:.6f} ms per call over the {W} chunks (CUDA "
          f"events, {KERNEL_REPS} calls; the merge launch alone "
          f"{split[0]:.6f}, the pack alone {split[1]:.6f}), plain "
          f"({plain.__name__}) "
          f"{plain_ms:.4f} ms; {n_look} rank "
          f"lookups, bound {cost['bound_ms']:.8f} ms ({cost['bound_by']}), "
          f"{ms / cost['bound_ms']:.1f}x; max |kernel - plain| = {err}; "
          f"gpt pattern on {len(gtext.encode())} bytes: {len(gids)} ids == "
          f"cpu [{CARD}]")
    print(f"{tag}: kernel on the {len(g_lens)} GPT chunks of the same "
          f"{nbytes} bytes (longest {int(g_lens.max())}): {g_ms:.6f} ms per "
          f"call (merge {g_split[0]:.6f}, pack {g_split[1]:.6f}); {g_look} "
          f"rank lookups, bound {g_cost['bound_ms']:.8f} ms "
          f"({g_cost['bound_by']}), {g_ms / g_cost['bound_ms']:.1f}x; max "
          f"|kernel - plain| = {g_err} [{CARD}]")
    return dict(launches=launches, max_abs_err=max(err, g_err), ms=ms,
                plain_ms=plain_ms, **cost, library_ms=None)


# ---------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------

UNI_DEFAULT = dict(target_vocab_size=8192, seed_size=100_000)  # bench.py:400
UNI_1024 = dict(target_vocab_size=1024, seed_size=10_000)      # bench.py:378
UNI_ENCODE_CHARS = 1_000_000


class Recorder:
    """A kernel wrapper that keeps the arguments of each call."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n


def uni_both(args) -> tuple[float, float, bool, bool]:
    """U1 and U2 against their plain versions on the same card tensors:
    (max |U1 - plain| over the counts, the log-likelihood's relative
    difference, counts within rtol=1e-5 / atol=1e-6, U2's pieces, counts
    and scores identical (and its scores-only form's))."""
    from shredword_tpu_torch.ops import unigram_ops as U

    counts, ll = U.fb_core(*args)
    pc, pll = U.fb_core_plain(*args)
    err = float((counts - pc).abs().max()) if len(pc) else 0.0
    ll_rel = abs(float(ll) - float(pll)) / max(abs(float(pll)), 1e-300)
    close = bool(torch.allclose(counts, pc, rtol=1e-5, atol=1e-6))
    got = U.viterbi_core(*args[:3])
    want = U.viterbi_core_plain(*args[:3])
    _, _, final = U.viterbi_core(*args[:3], backtrace=False)
    same = (all(torch.equal(a, b) for a, b in zip(got, want))
            and torch.equal(final, want[2]))
    return err, ll_rel, close, same


def phase_uni_vs_plain(device) -> None:
    """U1 and U2 against their plain versions on the card, on the seeded
    lattices of tests/torch_unigram_cases.py: absent cells, an all-absent
    row, a word no piece covers, pieces pruned to logp -1e30 (and a word
    whose one path goes through one), words of length 1 and L, ties
    everywhere, K = 1, L = 70 (the kernels' global-scratch mode), and
    words whose one path runs through pruned pieces until U1's
    posteriors overflow (counted as 1)."""
    from shredword_tpu_torch.ops import unigram_ops as U
    from torch_unigram_cases import LATTICES, overflow_lattice, random_lattice

    for case in sorted(LATTICES) + ["overflow"]:
        table, wlen, wcount, logp = (overflow_lattice() if case == "overflow"
                                     else random_lattice(case))
        dt = U.make_device_table(table, wlen, wcount, device)
        err, ll_rel, close, same = uni_both(uni_args(dt, logp))
        W, L, K = table.shape
        print(f"[unigram] seeded {case} [L {L}, K {K}, W {W}]: max |U1 - "
              f"plain| = {err:.3e}, log-likelihood relative difference "
              f"{ll_rel:.3e}, U2 identical: {same}")
        check(close and ll_rel <= 1e-6,
              f"U1 == plain within rtol 1e-5, atol 1e-6, {case}")
        check(same, f"U2 == plain, {case}")


def uni_args(dt, logp):
    lp = torch.from_numpy(np.asarray(logp, np.float32)).to(dt.ids.device)
    return dt.ids, lp, dt.wlen, dt.wcount


def cells_inside(wlen: np.ndarray, K: int) -> int:
    """Cells (start j, length k + 1) inside the words: the sum over the
    words of sum_j min(K, len - j)."""
    n = wlen.astype(np.int64)
    return int(np.where(n <= K, n * (n + 1) // 2,
                        K * (K + 1) // 2 + (n - K) * K).sum())


def uni_kernel_ms(args, *, fb: bool, backtrace: bool = False,
                  hot: int = 0) -> float:
    """Device ms per launch of U1 (fb) or U2 alone on these inputs:
    KERNEL_REPS back-to-back launches through the library (uncounted)
    between two CUDA events, the outputs allocated once.  U1 sums the
    `hot` most frequent ids of the table per block in shared memory."""
    from shredword_tpu_torch.ops import _kernels
    from shredword_tpu_torch.ops import unigram_ops as U

    ids, lp, wlen, wcount = args
    L, K, W = ids.shape
    check(L <= U.LOCAL_L, "the timed slabs need no global scratch")
    dev = ids.device
    k = _kernels.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = torch.zeros(lp.shape[0], dtype=torch.float64, device=dev)
    ll = torch.zeros(1, dtype=torch.float64, device=dev)
    final = torch.empty(W, dtype=torch.float32, device=dev)
    out = torch.empty((L, W), dtype=torch.int32, device=dev)
    count = torch.empty(W, dtype=torch.int32, device=dev)
    ptr = (lambda t: t.data_ptr() if backtrace else None)
    h_ids, slot = U.hot_ids(ids, hot)
    H = h_ids.shape[0]

    def calls():
        for _ in range(KERNEL_REPS):
            rc = (k.shred_unigram_fb(ids.data_ptr(), lp.data_ptr(),
                                     lp.shape[0], wlen.data_ptr(),
                                     wcount.data_ptr(), L, K, W,
                                     h_ids.data_ptr() if H else None,
                                     slot.data_ptr() if H else None, H,
                                     None, counts.data_ptr(), ll.data_ptr(),
                                     stream) if fb
                  else k.shred_unigram_viterbi(
                      ids.data_ptr(), lp.data_ptr(), wlen.data_ptr(), L, K,
                      W, None, ptr(out), ptr(count), final.data_ptr(),
                      stream))
            check(rc == 0, "unigram kernel launch")

    calls()
    return elapsed_ms(calls, dev) / KERNEL_REPS


PROFILE_PAUSE_S = 0.02


PROFILE_TRACES = 3


def kernel_launches(fn, name, calls: int = 3, expect: int = 1) -> int:
    """Launches of kernels named `name` (or any name of a tuple) in
    `calls` calls of fn, from torch.profiler, after one untraced warm-up
    call.  The profiler keeps only the device events inside its
    host-clock window, so an event that ends right before the trace
    stops can be dropped, and late in this script's process it can miss
    the device events of a trace's first call (P1's first traced call
    lost 1-3 of its 4 kernels, the later calls none).  So the trace
    starts with one uncounted call; the counted calls follow in a
    record_function region, each after a host pause with the device
    idle; only device events from the region's start on count, and the
    trace stops a pause after the last call has finished.  It has also
    missed every counted call of a trace (U1 on one E-step slab, one run
    in several): a trace that counts other than `expect` launches per
    call is printed and taken again, up to PROFILE_TRACES traces, and
    the last count is returned, so a kernel that launches otherwise
    differs in every trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    names = (name,) if isinstance(name, str) else name
    fn()
    torch.cuda.synchronize()
    for trace in range(PROFILE_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("counted calls"):
                for _ in range(calls):
                    time.sleep(PROFILE_PAUSE_S)
                    fn()
                    torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
        events = prof.events()
        (region,) = [e for e in events if e.name == "counted calls"
                     and e.device_type == DeviceType.CPU]
        n = sum(1 for e in events
                if e.device_type == DeviceType.CUDA
                and e.time_range.start >= region.time_range.start
                and any(k in e.name for k in names))
        if n == expect * calls:
            break
        print(f"[profiler] trace {trace + 1} of {PROFILE_TRACES} counted "
              f"{n} launches of {'/'.join(names)} in {calls} calls, not "
              f"{expect * calls}")
    return n


def uni_slab(tag: str, args, *, fb: bool) -> dict:
    """One real slab: the kernel against its plain version (the form
    train() calls: U1, or U2 scores-only), both timed, its launches per
    call, its bound from the bytes and operations this slab needs, and
    for U1 the same launch with no hot ids in shared memory (every
    count a global atomic, as in a one-thread-per-word kernel) and with
    every present cell's id made distinct (the same work without the
    hot pieces' atomics).  Returns the kernels-line record."""
    from shredword_tpu_torch.ops import unigram_ops as U

    ids, lp, wlen, wcount = args
    L, K, W = ids.shape
    n = lp.shape[0]
    err, ll_rel, close, same = uni_both(args)
    check(close and ll_rel <= 1e-6 and same,
          f"U1 and U2 == plain on the real slab {tag}")
    present = ids >= 0
    n_present = int(present.sum())
    hot = int(torch.bincount(ids[present].long(), minlength=n).max())
    wl = wlen.cpu().numpy()
    inside = cells_inside(wl, K)
    if fb:
        ms = uni_kernel_ms(args, fb=True, hot=U.HOT_IDS)
        ms_cold = uni_kernel_ms(args, fb=True, hot=0)
        plain = lambda: U.fb_core_plain(*args)             # noqa: E731
        launch = lambda: U.fb_core(*args)                  # noqa: E731
        # the table's cells, lp, wlen, wcount in; float64 counts and ll
        # out.  Per present cell: an exp and three adds forward and
        # backward, an exp, four adds and a product for its posterior;
        # a log and two adds per position and direction
        cost = bound(4 * inside + 4 * n + 8 * W + 8 * n + 8,
                     13 * n_present + 4 * int(wl.sum()))
        spread = torch.where(present, torch.arange(
            ids.numel(), device=ids.device, dtype=torch.int32).view_as(ids)
            % n, -1)
        ms_spread = uni_kernel_ms((spread, lp, wlen, wcount), fb=True,
                                  hot=U.HOT_IDS)
        name = "fb_kernel"
    else:
        ms = uni_kernel_ms(args, fb=False)
        ms_bt = uni_kernel_ms(args, fb=False, backtrace=True)
        plain = lambda: U.viterbi_core_plain(                 # noqa: E731
            *args[:3], backtrace=False)
        launch = lambda: U.viterbi_core(                      # noqa: E731
            *args[:3], backtrace=False)
        # the cells, lp, wlen in, the scores out; an add and a compare
        # per present cell
        cost = bound(4 * inside + 4 * n + 8 * W, 2 * n_present)
        name = "viterbi_kernel"
    plain()                                                    # warm-up
    plain_ms = elapsed_ms(plain, ids.device)
    n_calls = 3
    traced = kernel_launches(launch, name, n_calls)
    check(traced == n_calls, f"one {name} launch per call, {tag}: "
          f"the profiler counted {traced} in {n_calls} calls")
    per_call = traced // n_calls
    line = (f"[unigram] {tag} [L {L}, K {K}, W {W}], {n} pieces: "
            f"{n_present} present cells of {inside} inside the words, the "
            f"hottest piece in {hot}; ")
    if fb:
        line += (f"U1 {ms:.6f} ms per call with {U.HOT_IDS} hot ids "
                 f"in shared memory ({ms_cold:.6f} with none: every "
                 f"count a global atomic; {ms_spread:.6f} with every "
                 f"cell's id distinct: no hot atomics), plain "
                 f"{plain_ms:.4f} ms, max |U1 - plain| = {err:.3e} (ll "
                 f"relative {ll_rel:.3e}), ")
    else:
        line += (f"U2 scores only {ms:.6f} ms per call (with the "
                 f"backtrace {ms_bt:.6f}), plain {plain_ms:.4f} ms, "
                 f"identical, ")
    print(line + f"{per_call} launch per call (profiler), bound "
          f"{cost['bound_ms']:.8f} ms ({cost['bound_by']}), "
          f"{ms / cost['bound_ms']:.1f}x")
    return dict(max_abs_err=err if fb else 0, ms=ms, plain_ms=plain_ms,
                **cost, library_ms=None)


def phase_uni_slabs(device, corpus) -> dict:
    """U1 on the default config's real slabs at the seed pieces, and U2
    on the first prune's first slab (the seed pieces' strings, each
    without its own arc), as train() builds them."""
    from shredword_tpu_torch import UnigramTrainer
    from shredword_tpu_torch.ops import unigram_ops as U

    t = UnigramTrainer(**UNI_DEFAULT, device=device)
    t.load_corpus(corpus)
    pieces, counts = t._seed()
    logp = np.log(counts / counts.sum())
    slabs = t._dev_slab_tables(pieces)
    rec = Recorder(U.viterbi_core)
    U.viterbi_core = rec
    try:
        t._prune_loss(pieces, logp, counts.astype(np.float64))
    finally:
        U.viterbi_core = rec.fn
    out = {}
    for i, dt in enumerate(slabs):
        r = uni_slab(f"E-step slab {i}", uni_args(dt, logp), fb=True)
        out.setdefault("fb", r)                # the largest slab's
    ids, lp, wlen = rec.calls[0][0]
    zero = torch.zeros(wlen.shape[0], dtype=torch.float32, device=device)
    out["viterbi"] = uni_slab("prune slab 0", (ids, lp, wlen, zero),
                              fb=False)
    return out


def phase_uni_overflow(device, out_dir) -> None:
    """Training that reaches words split only through pruned pieces
    (tests/torch_unigram_cases.OVERFLOW_TEXT): U1 on the card gives a
    finite model that encodes its own corpus, with the pieces of the
    plain versions' run (device="cpu")."""
    from shredword_tpu_torch import UnigramTokenizer, UnigramTrainer
    from shredword_tpu_torch.ops import unigram_ops as U
    from torch_unigram_cases import OVERFLOW_CONFIG, OVERFLOW_TEXT

    path = os.path.join(out_dir, "overflow.txt")
    with open(path, "w") as f:
        f.write(OVERFLOW_TEXT)
    runs = []
    for dev in (device, "cpu"):
        n0 = U.fb_core.launches
        t = UnigramTrainer(**OVERFLOW_CONFIG, device=dev)
        t.load_corpus(path)
        t.train()
        runs.append((t, U.fb_core.launches - n0))
    (card, u1), (cpu, _) = runs
    check(u1 > 0, "U1 launched on the overflow corpus")
    check(bool(np.isfinite(card.log_probs).all())
          and bool(np.isfinite(card.final_ll)),
          "U1 gives finite log-probs on the overflow corpus")
    check(card.pieces == cpu.pieces, "overflow corpus: card pieces == "
          "device='cpu'")
    model = os.path.join(out_dir, "overflow.model")
    card.save(model)
    tok = UnigramTokenizer.load(model, device=device)
    check(tok.decode(tok.encode_array(OVERFLOW_TEXT))
          == OVERFLOW_TEXT.lower(), "the overflow model encodes its corpus")
    print(f"[unigram] overflow corpus: {len(card.pieces)} pieces, all "
          f"log-probs finite, final LL {card.final_ll!r} on the card "
          f"({u1} U1 launches), {cpu.final_ll!r} with device='cpu', pieces "
          f"identical, max |log_probs diff| "
          f"{float(np.abs(card.log_probs - cpu.log_probs).max()):.3e}; "
          f"the model encodes its corpus")


def path_score(log_probs: np.ndarray, ids: list[int]) -> float:
    return float(np.sum(log_probs[ids]))


def phase_uni_main(device, corpus, text: str, out_dir) -> dict:
    """The main path at the JAX bench's default config (bench.py:400-420):
    UnigramTrainer(8192 pieces, seed 100,000) load_corpus -> train ->
    save, then UnigramTokenizer.load(...).encode_array on the first
    1,000,000 characters.  Returns U1's and U2's launches in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shredword_tpu_torch import UnigramTokenizer, UnigramTrainer
    from shredword_tpu_torch.ops import unigram_ops as U

    tag = "[unigram] default config"
    reset_counts()
    t = UnigramTrainer(**UNI_DEFAULT, device=device)
    t0 = time.perf_counter()
    t.load_corpus(corpus)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAUSE_S)          # see kernel_launches
        t0 = time.perf_counter()
        n = t.train()
        torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
        time.sleep(PROFILE_PAUSE_S)
    u1, u2 = U.fb_core.launches, U.viterbi_core.launches
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us(dev) / (train_s * 1e6)
    k1 = [e for e in dev if "fb_kernel" in e.name]
    k2 = [e for e in dev if "viterbi_kernel" in e.name]
    check(n == UNI_DEFAULT["target_vocab_size"], "the default config "
          "trains 8192 pieces")
    check(u1 > 0 and u2 > 0, "train() launched U1 and U2")
    check(len(k1) == u1 and len(k2) == u2, "one launch per U1 / U2 call: "
          f"the profiler counted {len(k1)} / {len(k2)}, the wrappers "
          f"{u1} / {u2}")
    model = os.path.join(out_dir, "uni_default.model")
    t.save(model)
    layers = ", ".join(f"{k} {v:.3f}" for k, v in t.timings.items())
    print(f"{tag}: timings e_step {t.timings['e_step']!r} s, prune "
          f"{t.timings['prune']!r} s")
    print(f"{tag}: {n} pieces, train {train_s:.3f} s (under torch.profiler,"
          f" CUDA activity), load_corpus {load_s:.3f} s; final LL "
          f"{t.final_ll:.6g}, {t.final_ll_per_word:.6f} per word, "
          f"{t.final_ll_per_byte:.6f} per byte; U1 {u1} launches "
          f"({busy_us(k1) / 1e3:.3f} ms), U2 {u2} ({busy_us(k2) / 1e3:.3f} "
          f"ms) per train(); device busy {busy:.5f} of train(); host "
          f"layers (s): {layers}")
    tok = UnigramTokenizer.load(model, device=device)
    nbytes = len(text.encode())
    t0 = time.perf_counter()
    ids = tok.encode_array(text)
    first_s = time.perf_counter() - t0
    u2_enc = U.viterbi_core.launches - u2
    check(u2_enc > 0, "encode launched U2")
    enc = best_mbs(lambda: tok.encode_array(text), nbytes)
    dec = best_mbs(lambda: tok.decode(ids), nbytes)
    # normalized: ASCII lowercase, whitespace runs to one space
    check(tok.decode(ids) == " ".join(text.split()).lower(),
          "encode_array on 1 MB decodes back to the normalized text")
    n_words = max(text.count(" ") + text.count("\n") + 1, 1)
    # the device ids against the host DP on every distinct word; a
    # float32 near-tie may pick another path of the same score
    flips = 0
    for w, got in tok._memo.items():
        want = tok.encode_word(w)
        if got != want:
            flips += 1
            a = path_score(tok.log_probs, got)
            b = path_score(tok.log_probs, want)
            check(b"".join(tok.pieces[i] for i in got) == w
                  and abs(a - b) <= 1e-6 * abs(b),
                  f"another path of the same score for {w!r}: {a} {b}")
    print(f"{tag}: encode_array of {nbytes} bytes -> {len(ids)} ids, "
          f"{len(ids) / n_words:.4f} pieces per word; first call "
          f"{first_s:.3f} s ({u2_enc} U2 launches over "
          f"{len(tok._memo)} distinct words), then {enc:.3f} MB/s (best "
          f"of 3), decode {dec:.3f} MB/s; ids == the host DP on every "
          f"distinct word but {flips} (equal path scores)")
    return dict(fb=u1, viterbi=u2 + u2_enc)


def cutoff(t, pieces, loss) -> float:
    """The smallest loss a prune keeps among the prunable pieces."""
    keep = t._keep_from_loss(pieces, loss)
    free = keep & ~t._required(pieces) & np.isfinite(loss)
    return float(loss[free].min())


def train_1024(device, corpus, **kw):
    """(trainer, [(pieces, loss) per prune], seconds of train())."""
    from shredword_tpu_torch import UnigramTrainer

    t = UnigramTrainer(**UNI_1024, device=device, **kw)
    t.load_corpus(corpus)
    losses = []
    prune_loss = t._prune_loss

    def recorded(pieces, logp, exp_counts):
        loss = prune_loss(pieces, logp, exp_counts)
        losses.append((list(pieces), loss))
        return loss

    t._prune_loss = recorded
    t0 = time.perf_counter()
    t.train()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return t, losses, time.perf_counter() - t0


def phase_uni_1024(device, corpus):
    """The bench's 1,024-piece config (bench.py:378-397) on the card and
    with device="cpu" (the plain versions): pieces identical and
    log_probs within 1e-5.  If a prune's near-tie flips a piece, the
    pieces and losses print and the run passes only if each flipped
    piece's loss lies within 1e-6 relative of that prune's cutoff."""
    tag = "[unigram] 1024-piece config"
    card, lc, sc = train_1024(device, corpus)
    cpu, lp_, sp = train_1024("cpu", corpus)
    print(f"{tag}: train {sc:.3f} s on the card, {sp:.3f} s with "
          f"device='cpu'; host layers on the card (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in card.timings.items()))
    check(len(card.pieces) == UNI_1024["target_vocab_size"],
          "the 1,024-piece config trains 1024 pieces")
    flipped = False
    for r, ((pa, la), (pb, lb)) in enumerate(zip(lc, lp_)):
        check(pa == pb, f"equal pieces before prune {r}")
        ka, kb = card._keep_from_loss(pa, la), cpu._keep_from_loss(pb, lb)
        diff = np.nonzero(ka != kb)[0]
        if len(diff):
            ca, cb = cutoff(card, pa, la), cutoff(cpu, pb, lb)
            for i in diff:
                print(f"{tag}: prune {r} flips {pa[i]!r}: loss {la[i]!r} "
                      f"(card, cutoff {ca!r}) / {lb[i]!r} (cpu, cutoff "
                      f"{cb!r})")
                check(abs(la[i] - ca) <= 1e-6 * abs(ca)
                      and abs(lb[i] - cb) <= 1e-6 * abs(cb),
                      "a flipped piece's loss lies within 1e-6 of the "
                      "cutoff")
            flipped = True
            break
    if not flipped:
        check(card.pieces == cpu.pieces, "card pieces == device='cpu'")
        err = float(np.abs(card.log_probs - cpu.log_probs).max())
        check(np.allclose(card.log_probs, cpu.log_probs, rtol=1e-5,
                          atol=1e-5), "log_probs within 1e-5")
        print(f"{tag}: pieces identical on the card and the CPU, max "
              f"|log_probs diff| {err:.3e}")
    return card


def phase_uni_sharded(device, corpus, card) -> None:
    """UnigramTrainer(mesh=...) over an NCCL group of world size 1 at the
    1,024-piece config: the single-device pieces."""
    import torch.distributed as dist

    from shredword_tpu_torch.parallel import multihost

    multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1,
                         rank=0)
    try:
        setup = first_collective(device)
        t, _, secs = train_1024(device, corpus,
                                mesh=multihost.global_mesh())
    finally:
        dist.destroy_process_group()
    err = float(np.abs(t.log_probs - card.log_probs).max())
    print(f"[unigram] sharded NCCL world 1, 1024 pieces: train {secs:.3f} s "
          f"(first all_reduce {setup:.3f} s apart), max |log_probs - "
          f"single device| {err:.3e}")
    check(t.pieces == card.pieces, "sharded pieces == single device")


# ---------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------

SHARDED_VOCAB = 65536       # the row-sharded giant engine's largest vocab
RANKS_VOCAB = 4608          # 2 gloo ranks: just past the hist engine
G1_SPIN_CYCLES = 240_000_000   # ~120 ms: the chain's 257 launches and 256
                               # collectives
# G1's two forms: a rank alone (no reduce: one persistent launch a call,
# as sharded training runs at world 1) and the chain (the reduces over the
# process group: two launches and two collectives a merge)
G1_FORMS = ("alone", "chain")


def group_reduces() -> dict:
    """G1's two reduces over the initialized default process group."""
    import torch.distributed as dist

    return dict(reduce_key=lambda k: dist.all_reduce(
        k, op=dist.ReduceOp.MAX), reduce_deltas=dist.all_reduce)


def g1_reduces(form: str) -> dict:
    return {} if form == "alone" else group_reduces()


def g1_layout(tokens, word_id, wc_word, v, rank=0, world=1):
    """Rank `rank`'s chunked layout of the corpus over `world` ranks, as
    sharded_giant_train lays it out (parallel/giant.rank_layout)."""
    from shredword_tpu_torch.parallel import giant as par_giant
    from shredword_tpu_torch.parallel import hist as par_hist

    c = par_hist.shard_layout(tokens, word_id, wc_word, world,
                              dtype=np.int32)
    return par_giant.rank_layout(par_hist.local_shard(c, rank, world), v)


def g1_nc_used(layout) -> int:
    cw = layout.tw.shape[1] // layout.presT.shape[1]
    return max(1, -(-layout.n_words // cw))


def g1_state(layout, v, unk, device, base=0, rows=None,
             group=None) -> list[torch.Tensor]:
    """[tw int32, wc, hist rows [base, base + rows), bounds, presT] of one
    rank on its chunked `layout`."""
    from shredword_tpu_torch.parallel import giant as par_giant

    tw = torch.tensor(layout.tw, device=device)
    wc = torch.tensor(layout.wc.reshape(-1), device=device)
    return [tw, wc, *par_giant.init_row_shard(tw, wc, unk, v, base,
                                              rows or v, group),
            torch.tensor(layout.presT, device=device)]


def run_g1_both(layout, v, device, *, form, unk, base=0, rows=None,
                group=None, outs=None, **kw):
    """run_both for G1 and its plain version in `form` (the chain reduces
    over the initialized default process group); the kernel's records go
    to `outs`."""
    from shredword_tpu_torch.ops import _kernels

    red = dict(g1_reduces(form), base=base, nc_used=g1_nc_used(layout))

    def kernel(*st, **ckw):
        recs = _kernels.giant_sharded_train(*st, **red, **ckw)
        if outs is not None:
            outs.append(recs)
        return recs

    return run_both(
        kernel, lambda *st, **ckw: _kernels.giant_sharded_train_plain(
            *st, **red, **ckw),
        lambda: g1_state(layout, v, unk, device, base, rows, group),
        device, unk=unk, **kw)


def g1_gloo_rank(rank, world, store, v, result, dev):
    """One gloo rank of G1's chain against its plain version on its row
    shard and chunked column block (spawned); writes the error, the
    merges and the kernel's records."""
    import torch.distributed as dist

    device = torch.device(dev)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        layout = g1_layout(*random_corpus(v + 5, 20000, 122), v, rank,
                           world)
        rows = v // world
        outs = []
        err, _, _, n = run_g1_both(
            layout, v, device, form="chain", unk=122, base=rank * rows,
            rows=rows, group=dist.group.WORLD, outs=outs, min_freq=2,
            merges=700, steps=96)
    finally:
        dist.destroy_process_group()
    recs = torch.cat(outs).cpu().numpy()
    with open(result, "w") as f:
        json.dump(dict(err=err, n=n, records=recs[:, :4].tolist()), f)


def phase_g1_vs_plain(device, out_dir) -> int:
    """G1 against its plain version on the card, call by call with a call
    past the end, in both forms (alone; the chain over the world-size-1
    NCCL group): seeded random corpora at vocab 5120 and 8192 (an unk
    byte, 'aaaa' runs, a min_pair_freq stop), and the int16-crossing
    resume of the 64k envelope; then the chain in 2 gloo ranks on the
    card, each on its shard.  Returns the largest difference."""
    from torch_dist_workers import (ENVELOPE_N_PREV, ENVELOPE_TARGET,
                                    envelope_corpus)

    from shredword_tpu_torch.ops import bpe_hist

    worst = 0
    for form in G1_FORMS:
        for v, min_freq, merges, steps in ((5120, 2, 700, 128),
                                           (8192, 2, 900, 256),
                                           (5120, 20000, 700, 64)):
            unk = 122                                   # the byte 'z'
            layout = g1_layout(*random_corpus(v + 3, 30000, unk), v)
            err, _, _, n = run_g1_both(layout, v, device, form=form, unk=unk,
                                       min_freq=min_freq, merges=merges,
                                       steps=steps)
            print(f"[g1] {form}: random corpus v={v} min_freq={min_freq}: "
                  f"{n} merges in calls of {steps} over "
                  f"{layout.presT.shape[1]} chunks, max |kernel - plain| = "
                  f"{err}")
            check(err == 0 and (n == merges) == (min_freq == 2) and n > 0,
                  f"G1 {form} == plain at v={v} min_freq={min_freq}")
            worst = max(worst, err)
        v = -(-(256 + ENVELOPE_TARGET) // 128) * 128
        outs = []
        tokens, word_id, counts, _ = envelope_corpus()
        err, _, _, n = run_g1_both(g1_layout(tokens, word_id, counts, v), v,
                                   device, form=form, unk=-1, min_freq=2,
                                   merges=14, steps=5, start=ENVELOPE_N_PREV,
                                   outs=outs)
        recs = torch.cat(outs).cpu()
        print(f"[g1] {form}: int16-crossing resume, v={v}, merges "
              f"{ENVELOPE_N_PREV}-{ENVELOPE_N_PREV + n}: largest id merged "
              f"{int(recs[recs[:, 3] == 1, :2].max())}, max |kernel - "
              f"plain| = {err}")
        check(err == 0 and n == 14 and bool((recs[:, :2] > 32767).any()),
              f"G1 {form} == plain across the int16 boundary")
        worst = max(worst, err)
    v, world = 1024, 2
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store_g1")
    results = [os.path.join(out_dir, f"g1_rank{r}.json")
               for r in range(world)]
    procs = [ctx.Process(target=g1_gloo_rank,
                         args=(r, world, store, v, results[r], str(device)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    check([p.exitcode for p in procs] == [0] * world,
          "G1 gloo ranks exited with 0")
    ranks = []
    for path in results:
        with open(path) as f:
            ranks.append(json.load(f))
    tokens, word_id, wc_word = random_corpus(v + 5, 20000, 122)
    hm, hf, _ = bpe_hist.hist_train(tokens, word_id, wc_word,
                                    target_merges=700, unk_id=122,
                                    min_pair_freq=2, lazy_final=True,
                                    device=device)
    for r, res in enumerate(ranks):
        recs = np.asarray(res["records"])
        did = recs[:, 3] == 1
        print(f"[g1] chain: gloo rank {r}/{world} on {device}, v={v}: "
              f"{res['n']} merges, max |kernel - plain| = {res['err']}")
        check(res["err"] == 0 and res["n"] == 700
              and np.array_equal(recs[did, :2], hm)
              and np.array_equal(recs[did, 2], hf),
              f"G1 rank {r} == plain == the single-device hist engine")
        worst = max(worst, res["err"])
    return worst


def g1_cost(layout, v, device, merges: int) -> tuple[dict, float, dict]:
    """What G1's first `merges` merges on `layout` at vocab v move on this
    run's data, counted in a rerun of one merge per call (the alone
    form), what changed found by comparing the state before and after:
    (bound() per merge, the mean chunks read per merge, bound() per merge
    of the bytes that the corpus pass actually reads).  The bound counts
    as giant_cost counts K3's: once per call, the used chunks' tokens in
    and out (int32) and their weights, and the live bounds in and out;
    per merge, the tokens of the columns that hold the pair in and out
    and their weight, the pick's row reads (n_refresh rows of live
    columns), the presence of a and b over the used chunks, every table
    cell and presence byte that changes (read and written), the key and
    the record.  The bytes read take, for the columns, every column of
    the flagged chunks in (tokens and weight) and the merged ones out.
    A compare per matched token, and per live bound and cell read for
    each row read."""
    from shredword_tpu_torch.ops import _kernels

    st = g1_state(layout, v, -1, device)
    tw, hist, presT = st[0], st[2], st[4]
    L = tw.shape[0]
    used = g1_nc_used(layout)
    cw = tw.shape[1] // presT.shape[1]
    w_used = used * cw
    hist0, presT0 = hist.clone(), presT.clone()
    common = 0
    nbytes = 8 * L * w_used + 4 * w_used + 8 * (256 + merges)
    read_bytes = 0
    ops = chunks = 0
    for i in range(merges):
        tw0 = tw.clone()
        rec = _kernels.giant_sharded_train(
            *st, base=0, unk=GIANT["unk_id"], min_freq=GIANT["min_pair_freq"],
            n_done=i, init_done=0, allowed=1, nc_used=used,
            steps=1)[0].tolist()
        check(rec[3] == 1, "G1 merges through the window")
        a, b, lim = rec[0], rec[1], 257 + i
        flagged = int(((presT0[a, :used] != 0)
                       & (presT0[b, :used] != 0)).sum())
        matched = int(((tw0[:-1] == a) & (tw0[1:] == b)).any(0).sum())
        cells = int((hist != hist0).sum())
        flags = int((presT != presT0).sum())
        common += (rec[4] * 4 * lim + 2 * used + 8 * cells + 2 * flags
                   + 8 + 20)
        nbytes += matched * (8 * L + 4)
        read_bytes += flagged * cw * (4 * L + 4) + matched * 4 * L
        ops += matched * L + rec[4] * 2 * lim
        chunks += flagged
        hist0.copy_(hist)
        presT0.copy_(presT)
        del tw0
    return (bound((nbytes + common) / merges, ops / merges),
            chunks / merges,
            bound((read_bytes + common) / merges, ops / merges))


def phase_g1_timed(device, arrays) -> dict:
    """G1 on the bench corpus's chunked layout at vocab GIANT_VOCAB, world
    1, the first TIMED_MERGES merges in one call, in both forms: against
    the plain version and timed (the whole loop, host included; the
    device's time with the call enqueued behind a spin kernel); launches
    per call, the mean chunks read per merge, the bound and the bound of
    the bytes the pass reads; the chain's host enqueue with and without
    its collectives.  Returns the alone form's JSON timing record (the
    form of sharded training at world 1)."""
    from shredword_tpu_torch.ops import _kernels

    layout = g1_layout(*arrays, GIANT_VOCAB)
    kw = dict(unk=GIANT["unk_id"], min_freq=GIANT["min_pair_freq"])
    kernel = _kernels.giant_sharded_train
    spin_ms = elapsed_ms(lambda: torch.cuda._sleep(G1_SPIN_CYCLES), device)
    n = TIMED_MERGES
    cost, chunks, read = g1_cost(layout, GIANT_VOCAB, device, n)
    L, W = layout.tw.shape
    out = {}
    for form in G1_FORMS:
        red = dict(g1_reduces(form), base=0, nc_used=g1_nc_used(layout))
        err, loop_k, ms_p, n_k = run_g1_both(layout, GIANT_VOCAB, device,
                                             form=form, merges=n, steps=n,
                                             **kw)
        check(err == 0 and n_k == n, f"G1 {form}: bench layout")
        td = Timed(kernel, lead=G1_SPIN_CYCLES)
        n0 = kernel.launches
        td(*g1_state(layout, GIANT_VOCAB, kw["unk"], device), **red,
           n_done=0, init_done=0, allowed=n, steps=n, **kw)
        launches = kernel.launches - n0
        ms_k, enq = td.ms() / n, td.enqueue_ms[0]
        check(enq < spin_ms, f"G1 {form}: the spin outlasts the enqueue")
        check(launches == (1 if form == "alone" else 2 * n + 1),
              f"G1 {form}: launches per call")
        print(f"[g1] {form}: bench layout {(L, W)} "
              f"({layout.presT.shape[1]} chunks of "
              f"{W // layout.presT.shape[1]}, {g1_nc_used(layout)} used) "
              f"v={GIANT_VOCAB}, world 1: first {n} merges in one call of "
              f"{launches} launches; device {ms_k:.6f} ms/merge (enqueued "
              f"in {enq:.3f} ms under a {spin_ms:.3f} ms spin: "
              f"{enq / n:.6f} ms/merge), whole loop {loop_k / n:.6f} "
              f"ms/merge, plain {ms_p / n:.4f} ms/merge; mean chunks read "
              f"{chunks:.3f} per merge; bound {cost['bound_ms']:.8f} ms "
              f"({cost['bound_by']}, {ms_k / cost['bound_ms']:.1f}x), of "
              f"the bytes read {read['bound_ms']:.8f} ms ({read['bound_by']}"
              f", {ms_k / read['bound_ms']:.1f}x); max |kernel - plain| = "
              f"{err}")
        out[form] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p / n,
                         bound_ms=cost["bound_ms"],
                         bound_by=cost["bound_by"], library_ms=None)

    def enqueue_ms(lead: int) -> float:
        """Host ms per merge to enqueue the chain's call from a fresh
        state, behind a spin of `lead` cycles (0: the device idle)."""
        st = g1_state(layout, GIANT_VOCAB, kw["unk"], device)
        torch.cuda.synchronize(device)
        if lead:
            torch.cuda._sleep(lead)
        t0 = time.perf_counter()
        kernel(*st, **group_reduces(), base=0, n_done=0, init_done=0,
               allowed=n, steps=n, nc_used=g1_nc_used(layout), **kw)
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize(device)
        check(ms < spin_ms, "G1: the spin outlasts the enqueue")
        return ms / n

    print(f"[g1] chain: host enqueue with both collectives, ms per merge: "
          f"{enqueue_ms(G1_SPIN_CYCLES):.6f} behind the spin, "
          f"{enqueue_ms(0):.6f} with the device idle")
    g1_chain_kernels(layout, device, n)
    return out["alone"]


def g1_chain_kernels(layout, device, n: int) -> None:
    """One call of the chain (n merges) under torch.profiler: each of its
    kernels' launches and mean device µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shredword_tpu_torch.ops import _kernels

    st = g1_state(layout, GIANT_VOCAB, GIANT["unk_id"], device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAUSE_S)
        _kernels.giant_sharded_train(
            *st, base=0, **group_reduces(), unk=GIANT["unk_id"],
            min_freq=GIANT["min_pair_freq"], n_done=0, init_done=0,
            allowed=n, steps=n, nc_used=g1_nc_used(layout))
        torch.cuda.synchronize(device)
        time.sleep(PROFILE_PAUSE_S)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for name in ("apply_pick_kernel", "merge_kernel"):
        us = [e.time_range.elapsed_us() for e in dev if name in e.name]
        mean = f"mean {sum(us) / len(us):.3f} µs" if us else "none seen"
        print(f"[g1] chain: {name} under torch.profiler, one call of {n} "
              f"merges: {len(us)} launches, {mean}")


def profile_g1_train(corpus, device, mesh, vocab: int) -> None:
    """One sharded train() at `vocab` under torch.profiler: G1's launches
    against the wrapper's count (one a call at world 1), and the device
    busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shredword_tpu_torch import BPETrainer
    from shredword_tpu_torch.ops import _kernels

    kernel = _kernels.giant_sharded_train
    t = BPETrainer(target_vocab_size=vocab, backend="cuda", device=device,
                   mesh=mesh, **GIANT)
    try:
        t.load_corpus(corpus)
        torch.cuda.synchronize(device)
        n0 = kernel.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAUSE_S)
            t0 = time.perf_counter()
            merges = t.train()
            torch.cuda.synchronize(device)
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_PAUSE_S)
    finally:
        t.destroy()
    launches = kernel.launches - n0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in dev if "sharded_train_kernel" in e.name
            or "apply_pick_kernel" in e.name or "merge_kernel<" in e.name]
    print(f"[sharded giant] profiled train() vocab {vocab}, NCCL world 1: "
          f"{merges} merges, {len(ours)} G1 launches ({launches} counted), "
          f"{len(dev)} device events, device busy "
          f"{busy_us(dev) / wall_us:.3f} of the run ({wall_us / 1e3:.2f} "
          f"ms under the profiler), G1 {busy_us(ours) / 1e3:.2f} ms")
    check(len(ours) == launches and 0 < launches <= merges // 256 + 1,
          f"the profiler saw every G1 launch of the sharded train() at "
          f"{vocab}, one a call")


def g1_train_layers(corpus, device, mesh, vocab: int) -> None:
    """One sharded train() at `vocab` split into its layers on the host
    clock: the hist engine's decline; in the giant engine the int32
    layout (shard_layout), the rank's chunked layout (rank_layout), the
    initial rows (init_row_shard, the device synchronized after it), the
    call loop (drive_calls) and the rest (the upload); in the loop G1's
    enqueue (the wrapper's host time), the wait for each call's records
    (a synchronize after the call, where their readback would wait) and
    drive_calls' own work; and train() outside the engines."""
    from shredword_tpu_torch import BPETrainer
    from shredword_tpu_torch.ops import _kernels, bpe_hist
    from shredword_tpu_torch.parallel import giant as par_giant
    from shredword_tpu_torch.parallel import hist as par_hist

    clock = HostClock(device)
    patches = [(par_hist, "sharded_hist_train", False),
               (par_giant, "sharded_giant_train", False),
               (par_hist, "shard_layout", False),
               (par_giant, "rank_layout", False),
               (par_giant, "init_row_shard", True),
               (bpe_hist, "drive_calls", False),
               (_kernels, "giant_sharded_train", True)]
    saved = [getattr(m, name) for m, name, _ in patches]
    t = BPETrainer(target_vocab_size=vocab, backend="cuda", device=device,
                   mesh=mesh, **GIANT)
    try:
        t.load_corpus(corpus)
        for (m, name, sync), fn in zip(patches, saved):
            setattr(m, name, clock.wrap(name, fn, sync))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        merges = t.train()
        torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
    finally:
        for (m, name, _), fn in zip(patches, saved):
            setattr(m, name, fn)
        t.destroy()
    secs = clock.secs
    layers = {
        "train() outside the engines": total - secs["sharded_hist_train"]
        - secs["sharded_giant_train"],
        "hist engine's decline": secs["sharded_hist_train"],
        "int32 layout (shard_layout)": secs["shard_layout"],
        "chunked layout (rank_layout)": secs["rank_layout"],
        "initial rows (init_row_shard, host)": secs["init_row_shard"],
        "initial rows (device wait)": secs["init_row_shard wait"],
        "G1 enqueue": secs["giant_sharded_train"],
        "records' wait": secs["giant_sharded_train wait"],
        "driver": secs["drive_calls"] - secs["giant_sharded_train"]
        - secs["giant_sharded_train wait"],
        "giant engine's rest (upload)": secs["sharded_giant_train"]
        - secs["shard_layout"] - secs["rank_layout"]
        - secs["init_row_shard"] - secs["init_row_shard wait"]
        - secs["drive_calls"]}
    print(f"[sharded giant] train() vocab {vocab}, NCCL world 1, layer by "
          f"layer: {merges} merges in {total:.4f} s")
    for name, sec in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"[sharded giant]   {name}: {sec:.4f} s ({sec / total:.3f}, "
              f"{sec / merges * 1e3:.6f} ms per merge)")
    check(merges == vocab - 256, f"the layered train() merges at {vocab}")


def phase_sharded_giant_main(corpus, out_dir, device, giant_bytes) -> int:
    """The sharded main path over a world-size-1 NCCL group:
    BPETrainer(mesh=...) load_corpus -> train -> save at vocab 32768
    (== phase 6's single-device giant bytes) and 65536 (== the
    single-device flat engine's, its first merges == the 32768 run's),
    then both runs profiled and split into layers, then the sharded flat
    engine forced (the
    table engines patched to decline, as tests/test_parallel.py:132) at
    the headline (== the JAX golden digest).  Returns G1's launches in
    the 32768 run (every count set to 0 just before it, read just
    after)."""
    import torch.distributed as dist

    from shredword_tpu_torch.ops import _kernels
    from shredword_tpu_torch.parallel import giant as par_giant
    from shredword_tpu_torch.parallel import hist as par_hist
    from shredword_tpu_torch.parallel import multihost

    with open(os.path.join(ROOT, "tests", "golden", "bench_v768.json")) as f:
        golden = json.load(f)
    multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1,
                         rank=0)
    try:
        setup = first_collective(device)
        mesh = multihost.global_mesh()
        out = {}
        for vocab in (GIANT_VOCAB, SHARDED_VOCAB):
            reset_counts()
            timer = Timed(_kernels.giant_sharded_train)
            _kernels.giant_sharded_train = timer
            try:
                n, secs, raw, peak, model, vocab_b = train_and_save(
                    corpus, out_dir, vocab, device, cfg=GIANT,
                    tag="_sharded", mesh=mesh)
            finally:
                _kernels.giant_sharded_train = timer.fn
            out[vocab] = (_kernels.giant_sharded_train.launches, model,
                          vocab_b)
            print(f"[sharded giant] NCCL world 1, vocab {vocab}: first "
                  f"all_reduce {setup:.4f} s apart, {n} merges, train "
                  f"{secs:.4f} s ({secs / n * 1e3:.6f} ms per merge), "
                  f"{raw / 1e6 / secs:.3f} MB/s, peak device memory "
                  f"{peak / 1e9:.3f} GB, {out[vocab][0]} G1 launches in "
                  f"{len(timer.events)} calls, the calls' span "
                  f"{timer.ms() / n:.6f} ms per merge (CUDA events)")
            check(0 < out[vocab][0] == len(timer.events),
                  f"vocab {vocab} launched G1 once a call")
        launches, model, vocab_b = out[GIANT_VOCAB]
        check((model, vocab_b) == giant_bytes,
              f"sharded giant == single-device giant bytes at "
              f"{GIANT_VOCAB}")
        print(f"[sharded giant] vocab {GIANT_VOCAB}: .model/.vocab equal "
              f"the single-device giant engine's")
        _, model64, vocab64 = out[SHARDED_VOCAB]
        fn, fsecs, _, _, fmodel, fvocab = train_and_save(
            corpus, out_dir, SHARDED_VOCAB, device, "flat", GIANT)
        m32, m64 = merges_of(model), merges_of(model64)
        print(f"[sharded giant] vocab {SHARDED_VOCAB}: flat engine {fn} "
              f"merges in {fsecs:.4f} s")
        check((model64, vocab64) == (fmodel, fvocab),
              f"sharded giant == flat bytes at {SHARDED_VOCAB}")
        check(np.array_equal(m64[:len(m32)], m32)
              and len(m32) == GIANT_VOCAB - 256,
              "the 65536 run's first merges == the 32768 run's")
        print(f"[sharded giant] vocab {SHARDED_VOCAB}: .model/.vocab equal "
              f"the flat engine's; its first {len(m32)} merges equal the "
              f"{GIANT_VOCAB} run's")
        for vocab in (GIANT_VOCAB, SHARDED_VOCAB):
            profile_g1_train(corpus, device, mesh, vocab)
            g1_train_layers(corpus, device, mesh, vocab)
        engines = (par_hist.sharded_hist_train,
                   par_giant.sharded_giant_train)
        par_hist.sharded_hist_train = par_giant.sharded_giant_train = \
            lambda *a, **k: None
        try:
            n, secs, _, _, model, vocab_b = train_and_save(
                corpus, out_dir, 768, device, tag="_sharded_flat",
                mesh=mesh)
        finally:
            par_hist.sharded_hist_train, par_giant.sharded_giant_train = \
                engines
        check(hashlib.sha256(model).hexdigest() == golden["model_sha256"]
              and hashlib.sha256(vocab_b).hexdigest()
              == golden["vocab_sha256"] and n == golden["merges"],
              "sharded flat == JAX golden digest")
        print(f"[sharded flat] NCCL world 1, vocab 768 (table engines "
              f"declined): {n} merges, train {secs:.4f} s "
              f"({secs / n * 1e3:.4f} ms per merge); bytes equal the JAX "
              f"golden digest")
    finally:
        dist.destroy_process_group()
    return launches


def phase_sharded_giant_gloo(corpus, out_dir, device) -> None:
    """BPETrainer(shards=2) as 2 gloo ranks on the card at vocab
    RANKS_VOCAB (the headline config, so the sharded giant engine):
    bytes == the single-device giant engine's."""
    n, _, _, _, model, vocab_b = train_and_save(
        corpus, out_dir, RANKS_VOCAB, device, engine="giant")
    want = (hashlib.sha256(model).hexdigest(),
            hashlib.sha256(vocab_b).hexdigest())
    for r, res in enumerate(run_gloo_ranks(corpus, out_dir, RANKS_VOCAB,
                                           device)):
        print(f"[sharded giant] gloo rank {r}/2 on {device}, vocab "
              f"{RANKS_VOCAB}: first all_reduce {res['setup']:.4f} s, then "
              f"{res['n']} merges, train {res['secs']:.4f} s "
              f"({res['secs'] / res['n'] * 1e3:.4f} ms per merge), "
              f"{res['g1_launches']} G1 launches")
        check(res["g1_launches"] > 2 * res["n"],
              f"gloo rank {r} launched G1 at every merge")
        check(res["n"] == n and (res["model"], res["vocab"]) == want,
              f"2 gloo ranks, vocab {RANKS_VOCAB}: bytes == giant engine")
    print(f"[sharded giant] 2 gloo ranks, vocab {RANKS_VOCAB}: bytes equal "
          f"the single-device giant engine's")


# ---------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------

P1_KERNELS = ("totals_kernel", "mask_kernel")


def byte_offsets(cp: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Character-space starts as UTF-8 byte offsets."""
    blen = np.where(cp < 0x80, 1,
                    np.where(cp < 0x800, 2, np.where(cp < 0x10000, 3, 4)))
    off = np.zeros(len(cp) + 1, np.int64)
    np.cumsum(blen, out=off[1:])
    return off[starts]


def p1_kernel_ms(cls: torch.Tensor, n: int, device) -> float:
    """Device ms per call of P1's two launches alone: KERNEL_REPS
    back-to-back calls between two CUDA events, through the library
    directly (uncounted), the output and the stream's tile-status array
    allocated once."""
    from shredword_tpu_torch.ops import _kernels, pretok_ops

    out = torch.empty(n, dtype=torch.bool, device=device)
    k = _kernels.lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    status = pretok_ops.p1_status(device, stream, n)

    def calls():
        for _ in range(KERNEL_REPS):
            check(k.shred_gpt_starts_mask(
                cls.data_ptr(), n, status.data_ptr(), out.data_ptr(),
                stream) == 0, "P1 launch")

    calls()
    return elapsed_ms(calls, device) / KERNEL_REPS


def kernel_us(fn, names, calls: int = 5) -> dict:
    """Mean device µs per call of each kernel named in `names` over
    `calls` calls of fn, from torch.profiler's kernel durations (after an
    uncounted call, as kernel_launches does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("timed calls"):
            for _ in range(calls):
                time.sleep(PROFILE_PAUSE_S)
                fn()
                torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
    events = prof.events()
    (region,) = [e for e in events if e.name == "timed calls"
                 and e.device_type == DeviceType.CPU]
    return {k: sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA and k in e.name
                   and e.time_range.start >= region.time_range.start) / calls
            for k in names}


def p1_profile_child(cp_path: str, sizes) -> dict:
    """In a fresh process: P1's launches per call and device µs per
    kernel on the first `sizes` code points of cp_path, and one profiled
    gpt_starts_device call on all of them (its P1 launches, device busy
    share)."""
    from functools import partial

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from shredword_tpu_torch.ops import pretok_ops

    cp = np.load(cp_path)
    out = {}
    for k in sizes:
        cls = torch.from_numpy(pretok_ops.class_table()[cp[:k]].astype(
            np.int8)).cuda()
        call = partial(pretok_ops.gpt_starts_mask, cls, k)
        out[str(k)] = (kernel_launches(call, P1_KERNELS, expect=2) / 3,
                       kernel_us(call, P1_KERNELS))
    pretok_ops.gpt_starts_device(cp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pretok_ops.gpt_starts_device(cp)     # uncounted: see kernel_launches
        time.sleep(PROFILE_PAUSE_S)
        with record_function("measured call"):
            t0 = time.perf_counter()
            pretok_ops.gpt_starts_device(cp)
            wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAUSE_S)
    (region,) = [e for e in prof.events() if e.name == "measured call"
                 and e.device_type == DeviceType.CPU]
    # the device events of the measured call, without the region's own
    # annotation on the device's timeline
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name != "measured call"
                  and e.time_range.start >= region.time_range.start]
    out["main"] = (sum(any(k in e.name for k in P1_KERNELS)
                       for e in dev_events),
                   busy_us(dev_events) / wall_us)
    return out


def p1_profiled(cp: np.ndarray, sizes) -> dict:
    """p1_profile_child run in a fresh python process (late in this one,
    the profiler drops device events: PERF.md §7)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.npy")
        np.save(path, cp)
        code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]"
                "; import chip_smoke; print(json.dumps("
                "chip_smoke.p1_profile_child(sys.argv[3], "
                "[int(x) for x in sys.argv[4:]])))")
        out = subprocess.run(
            [sys.executable, "-c", code, ROOT, os.path.join(ROOT, "tests"),
             path, *map(str, sizes)], capture_output=True, text=True,
            timeout=CLI_TIMEOUT)
    check(out.returncode == 0, f"the P1 profile process: {out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def synced(fn):
    """fn, then a synchronise: its host time includes the device work."""
    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def phase_pretok(device, enc_text: str) -> tuple[dict, int]:
    """P1 against its plain version on the card and timed; the main path
    gpt_starts_device on the 4M text, counted and timed layer by layer
    beside the native scanner.  Returns P1's kernel record (at 4M) and
    its launches in the main path's run."""
    from torch_pretok_cases import all_inputs, code_points

    from shredword_tpu_torch import pretokenize
    from shredword_tpu_torch.ops import pretok_ops

    table = pretok_ops.class_table()
    inputs = [table[code_points(s)].astype(np.int8) for s in all_inputs()]
    # one position of each class, and seeded classes one under and one
    # over a tile
    rng = np.random.RandomState(pretok_ops.GPT_TILE)
    inputs += [np.array([c], np.int8) for c in range(16)] + [
        rng.randint(0, 16, n).astype(np.int8)
        for n in (pretok_ops.GPT_TILE - 1, pretok_ops.GPT_TILE + 1)]
    err = 0
    for c in inputs:
        cls = torch.from_numpy(c).to(device)
        err = max(err, max_abs_diff(
            pretok_ops.gpt_starts_mask(cls, len(c)),
            pretok_ops.gpt_starts_mask_plain(cls, len(c))))
    print(f"[pretok] P1 against its plain version on the card, "
          f"{len(inputs)} seeded inputs (cases, fuzz strings, runs across "
          f"tile edges and longer than a tile, lengths 1 and a tile +- "
          f"1): max |kernel - plain| = {err}")
    check(err == 0, "P1 == plain on the seeded inputs")
    rec = None
    for chars in (ENCODE_CHARS, GPT_CHARS):
        text = enc_text[:chars]
        cp = code_points(text)
        n = len(cp)
        cls = torch.from_numpy(table[cp].astype(np.int8)).to(device)
        got = pretok_ops.gpt_starts_mask(cls, n)
        e = max_abs_diff(got, pretok_ops.gpt_starts_mask_plain(cls, n))
        starts = torch.nonzero(got).flatten().cpu().numpy()
        check(e == 0, f"P1 == plain on {n} characters")
        check(np.array_equal(byte_offsets(cp, starts),
                             pretokenize.gpt_starts_bytes(text.encode())),
              f"P1's starts == the native scanner's on {n} characters")
        ms = p1_kernel_ms(cls, n, device)
        plain_ms = elapsed_ms(
            lambda: [pretok_ops.gpt_starts_mask_plain(cls, n)
                     for _ in range(3)], device) / 3
        # a class byte in and a mask byte out per character; the five
        # scans' combines, one per character each (the boolean algebra
        # around them not counted)
        b = bound(2 * n, 5 * n)
        print(f"[pretok] P1 on {n} characters ({len(starts)} starts): "
              f"kernel {ms:.6f} ms per call (CUDA events, {KERNEL_REPS} "
              f"calls of its launches alone), plain {plain_ms:.4f} ms; "
              f"bound {b['bound_ms']:.8f} ms ({b['bound_by']}), "
              f"{ms / b['bound_ms']:.1f}x; max |kernel - plain| = {e}; "
              f"starts == the native scanner's [{CARD}]")
        if chars == ENCODE_CHARS:
            rec = dict(max_abs_err=max(err, e), ms=ms, plain_ms=plain_ms,
                       library_ms=None, **b)

    # the main path: gpt_starts_device on the 4M text
    text = enc_text[:ENCODE_CHARS]
    data = text.encode()
    cp = code_points(text)
    n = len(cp)
    reset_counts()
    starts = pretok_ops.gpt_starts_device(cp)
    torch.cuda.synchronize(device)
    launches = pretok_ops.gpt_starts_mask.launches
    check(launches > 0, "the main path (gpt_starts_device) launched P1")
    native = pretokenize.gpt_starts_bytes(data)
    check(np.array_equal(byte_offsets(cp, starts), native),
          "gpt_starts_device == the native scanner on the 4M text")
    nbytes = len(data)
    dev_mbs = best_mbs(lambda: pretok_ops.gpt_starts_device(cp), nbytes)
    nat_mbs = best_mbs(lambda: pretokenize.gpt_starts_bytes(data), nbytes)
    host_mbs = best_mbs(lambda: pretok_ops.gpt_starts(cp), nbytes)
    lookup_ms, cls_np = best_ms(lambda: table[cp].astype(np.int8))
    up_ms, cls = best_ms(synced(lambda: torch.from_numpy(cls_np).to(device)))
    mask_ms, mask = best_ms(synced(
        lambda: pretok_ops.gpt_starts_mask(cls, n)))
    down_ms, _ = best_ms(
        lambda: torch.nonzero(mask).flatten().cpu().numpy())
    prof = p1_profiled(cp, (ENCODE_CHARS, GPT_CHARS))
    for k in (ENCODE_CHARS, GPT_CHARS):
        per_call, split = prof[str(k)]
        print(f"[pretok] P1 on {k} characters, torch.profiler in a fresh "
              f"process: {per_call:g} launches per call; device µs per call "
              f"by kernel (alone after a pause): " + ", ".join(
                  f"{name} {us:.3f}" for name, us in split.items())
              + f" [{CARD}]")
        check(per_call == 2, "P1: two launches per call")
    traced, busy = prof["main"]
    print(f"[pretok] main path gpt_starts_device on {nbytes} bytes "
          f"({n} characters, {len(starts)} starts): {launches} P1 launches; "
          f"{dev_mbs:.3f} MB/s (best of 3), the native scanner "
          f"(gpt_starts_bytes) {nat_mbs:.3f} MB/s, the numpy splitter "
          f"(gpt_starts) {host_mbs:.3f} MB/s on the same bytes; device busy "
          f"{busy:.4f} of a call (profiled in the fresh process)")
    print(f"[pretok] gpt_starts_device layers (ms, best of 3): host class "
          f"lookup {lookup_ms:.3f}, upload {up_ms:.3f}, mask call "
          f"(gpt_starts_mask, synchronised) {mask_ms:.3f}, torch.nonzero and "
          f"download {down_ms:.3f}")
    check(traced == 2, f"the profiler saw P1's two launches in one "
          f"gpt_starts_device call, not {traced}")
    return rec, launches


# ---------------------------------------------------------------------
# phase 17
# ---------------------------------------------------------------------

CLI_TIMEOUT = 600
K1_KERNEL = "hist_train_kernel"          # csrc/hist_fused.cu


def cli_run(args: list[str], env=None) -> tuple[float, str]:
    """Run ``python -m shredword_tpu_torch <args>`` from the checkout:
    (wall-clock s, stdout).  A non-zero exit fails the phase."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "shredword_tpu_torch", *args],
                       capture_output=True, text=True, timeout=CLI_TIMEOUT,
                       cwd=ROOT, env=env)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"CLI {args[:2]} exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    return secs, r.stdout


def wall_s(code: str) -> tuple[float, str]:
    """(wall-clock s, stdout) of ``python -c code`` from the checkout."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=CLI_TIMEOUT, cwd=ROOT)
    check(r.returncode == 0, f"python -c failed: {r.stderr[-2000:]}")
    return time.perf_counter() - t0, r.stdout


def trace_kernels(trace_dir: str, name: str) -> int:
    """Kernel events named `name` in the one Chrome trace under
    trace_dir (utils/profiling.trace)."""
    (path,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, path)) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and name in e.get("name", ""))


def running(pid: int) -> bool:
    """Whether process `pid` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_daemon(sock: str) -> None:
    """Stop the daemon on `sock`: its own stop, then, if the pid its log
    names still runs after 30 s, a kill."""
    import signal

    subprocess.run([sys.executable, "-m", "shredword_tpu_torch", "daemon",
                    "stop", "--socket", sock], capture_output=True,
                   timeout=CLI_TIMEOUT, cwd=ROOT)
    if not os.path.exists(sock + ".log"):
        return
    with open(sock + ".log") as f:
        pids = [int(w.rstrip(")")) for line in f
                for w0, w in zip(line.split(), line.split()[1:])
                if w0 == "(pid"]
    for pid in pids:
        deadline = time.monotonic() + 30
        while running(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        if running(pid):
            os.kill(pid, signal.SIGKILL)
            print(f"[cli] daemon {pid} still ran 30 s after its stop: "
                  f"killed")


def phase_cli(corpus, out_dir, golden, enc_text: str, uni_pieces,
              device) -> None:
    """python -m shredword_tpu_torch in subprocesses on the card."""
    from shredword_tpu_torch import Tokenizer, UnigramTrainer

    d = os.path.join(out_dir, "cli")
    os.makedirs(d)

    def train_args(tag):
        return ["train", "--corpus", corpus, "--model",
                os.path.join(d, tag + ".model"), "--vocab-size", "768",
                "--min-pair-freq", "50", "--coverage", "0.9999",
                "--unk-id", "-1"]

    def check_golden(tag, out):
        with open(os.path.join(d, tag + ".model"), "rb") as f, \
                open(os.path.join(d, tag + ".vocab"), "rb") as g:
            model, vocab = f.read(), g.read()
        check(hashlib.sha256(model).hexdigest() == golden["model_sha256"]
              and hashlib.sha256(vocab).hexdigest() == golden["vocab_sha256"]
              and out.startswith(f"trained {golden['merges']} merges"),
              f"CLI train ({tag}) == the JAX golden digest")

    torch.cuda.empty_cache()
    python_s, _ = wall_s("pass")
    torch_s, _ = wall_s("import torch")
    _, split = wall_s(
        "import time, torch\n"
        "t0 = time.perf_counter(); torch.zeros(1, device='cuda')\n"
        "t1 = time.perf_counter()\n"
        "from shredword_tpu_torch.ops import _kernels; _kernels.lib()\n"
        "t2 = time.perf_counter()\n"
        "from shredword_tpu_torch.runtime import native; native.lib()\n"
        "print(t1 - t0, t2 - t1, time.perf_counter() - t2)")
    ctx_s, klib_s, hlib_s = map(float, split.split())
    cold_s, out = cli_run(train_args("cold"))
    check_golden("cold", out)
    info_s, info = cli_run(["info", os.path.join(d, "cold.model")])
    check(f"merges:   {golden['merges']}" in info, "CLI info")
    trace_dir = os.path.join(d, "trace")
    traced_s, out = cli_run(train_args("traced"),
                            env=dict(os.environ, SHREDWORD_TRACE=trace_dir))
    check_golden("traced", out)
    k1 = trace_kernels(trace_dir, K1_KERNEL)
    check(k1 > 0, "CLI train launched K1 (hist_fused.cu)")
    print(f"[cli] wall s: python alone {python_s:.3f}, import torch "
          f"{torch_s:.3f}, info (the package's import) {info_s:.3f}; in a "
          f"fresh process the CUDA context {ctx_s:.3f}, the kernel library "
          f"(cached build) {klib_s:.3f}, the host library {hlib_s:.3f}")
    print(f"[cli] train vocab 768 on the 16 MB corpus, fresh process: "
          f"{cold_s:.3f} s; under SHREDWORD_TRACE {traced_s:.3f} s, "
          f"{k1} {K1_KERNEL} launches in its trace; .model/.vocab == the "
          f"JAX golden digest")

    sock = os.path.join(d, "d.sock")
    env_d = dict(os.environ, SHREDWORD_TORCH_DAEMON="1",
                 SHREDWORD_TORCH_DAEMON_SOCKET=sock)
    try:
        first_s, out = cli_run(train_args("daemon1"), env=env_d)
        check_golden("daemon1", out)
        warm = []
        for i in range(2):
            secs, out = cli_run(train_args(f"daemon{i + 2}"), env=env_d)
            check_golden(f"daemon{i + 2}", out)
            warm.append(secs)
        _, status = cli_run(["daemon", "status", "--socket", sock])
        check(status.strip() == "daemon running", "the daemon still runs")
    finally:
        stop_daemon(sock)
    print(f"[cli] train through the daemon (SHREDWORD_TORCH_DAEMON=1): "
          f"first call (starts it) {first_s:.3f} s, warm calls "
          + ", ".join(f"{s:.3f}" for s in warm) + " s; == golden")

    text = enc_text[:UNI_ENCODE_CHARS]
    src, ids_path, back = (os.path.join(d, f) for f in
                           ("text.txt", "ids.txt", "back.txt"))
    with open(src, "w", encoding="utf-8") as f:
        f.write(text)
    model = os.path.join(d, "cold.model")
    enc_s, _ = cli_run(["encode", "--model", model, "--input", src,
                        "--output", ids_path])
    with open(ids_path) as f:
        ids = [int(x) for x in f.read().split()]
    want = Tokenizer.load(model, device=device).encode(
        text, allowed_special="all")
    check(ids == want, "CLI encode == the Tokenizer's ids on the card")
    dec_s, _ = cli_run(["decode", "--model", model, "--input", ids_path,
                        "--output", back])
    with open(back, encoding="utf-8") as f:
        check(f.read() == text, "CLI decode round-trips")
    uni = os.path.join(d, "u.model")
    uni_s, out = cli_run(["train-unigram", "--corpus", corpus, "--model",
                          uni, "--vocab-size", "1024", "--seed-size",
                          "10000"])
    check(UnigramTrainer.load_model(uni)[0] == uni_pieces,
          "CLI train-unigram == phase 14's 1,024 pieces")
    print(f"[cli] encode {len(text)} characters -> {len(ids)} ids "
          f"{enc_s:.3f} s (== the Tokenizer's ids), decode {dec_s:.3f} s "
          f"(round trip), train-unigram 1024 pieces {uni_s:.3f} s (== "
          f"phase 14's pieces); fresh process each")


# ---------------------------------------------------------------------
# phase 19
# ---------------------------------------------------------------------

F1_SOURCE = "shredword_tpu/ops/bpe_ops.py:243"       # train_loop
F1_TOO_FAR = 2**31 - 1       # a difference in a count, done or a length


def flat_diff(k, p) -> int:
    """max |F1 - plain| over two flat TrainStates: merges, frequencies
    and the compacted stream; F1_TOO_FAR if the merge count, done or a
    stream length differ."""
    from shredword_tpu_torch.ops import bpe_ops

    if (k.n_merges, k.done) != (p.n_merges, p.done):
        return F1_TOO_FAR
    err = max(int(np.abs(k.merges - p.merges).max()),
              int(np.abs(k.merge_freqs - p.merge_freqs).max()))
    for a, b in zip(bpe_ops.final_corpus(k.corpus), p.corpus):
        err = max(err, max_abs_diff(a, b) if a.shape == b.shape
                  else F1_TOO_FAR)
    return err


def flat_states(arrays, device, target, n_prev=0):
    """Two flat TrainStates of the same arrays on the card: F1's (its
    FlatState built) and the plain version's."""
    from shredword_tpu_torch.ops import bpe_ops

    k, p = (bpe_ops.train_init(bpe_ops.make_state(*arrays, device=device),
                               target, n_prev_merges=n_prev)
            for _ in range(2))
    return k._replace(corpus=bpe_ops.FlatState(k.corpus)), p


def flat_both(arrays, device, *, target, n_prev=0, unk, minf, steps):
    """F1 and its plain version call by call from the same arrays, then
    one call past the end (no launch, nothing changes); returns (max
    |diff| after every call, merges done, F1 ms, plain ms, the chunks F1's
    passes visited)."""
    from shredword_tpu_torch.ops import _kernels

    k, p = flat_states(arrays, device, target, n_prev)
    err, ms_k, ms_p, calls = 0, 0.0, 0.0, 0
    kw = dict(target_merges=target, max_steps=steps)
    n0 = _kernels.flat_train.launches
    while not p.done and p.n_merges < target:
        out = {}
        ms_k += elapsed_ms(lambda: out.__setitem__(
            "k", _kernels.flat_train(k, unk, minf, **kw)), device)
        ms_p += elapsed_ms(lambda: out.__setitem__(
            "p", _kernels.flat_train_plain(p, unk, minf, **kw)), device)
        k, p = out["k"], out["p"]
        calls += 1
        err = max(err, flat_diff(k, p))
    k = _kernels.flat_train(k, unk, minf, **kw)
    err = max(err, flat_diff(k, p))
    check(_kernels.flat_train.launches - n0 == calls,
          "one F1 launch per call with merges to make, none past the end")
    return err, p.n_merges - n_prev, ms_k, ms_p, k.corpus.visited


def flat_cost(arrays, device, n: int, cfg=GIANT) -> dict:
    """bound() per merge of the first n flat merges, from what they must
    move on this data: once, the stream's tokens in and out and each
    word's offset, length and count; per merge every pair whose count
    changed (its key and count read, its count written) and the record.
    A compare per pair ever counted and per live token, each merge.  The
    pair counts are the plain version's (bpe_ops.pair_counts), before
    and after each merge, so the bound does not depend on F1's layout;
    the first merge's changes include the initial count, as F1 counts
    the stream in its first call.  The merges are those of ``cfg``'s
    unk_id and min_pair_freq."""
    from shredword_tpu_torch.ops import _kernels, bpe_ops

    _, ts = flat_states(arrays, device, n)
    unk, minf = cfg["unk_id"], cfg["min_pair_freq"]
    words = int(torch.count_nonzero(torch.diff(ts.corpus.word_id))) + 1
    nbytes, ops = 8 * len(ts.corpus.tokens) + 12 * words, 0
    keys = seen = torch.empty(0, dtype=torch.int64, device=device)
    counts = keys
    for _ in range(n):
        ts = _kernels.flat_train_plain(ts, unk, minf, target_merges=n,
                                       max_steps=1)
        k2, c2 = bpe_ops.pair_counts(ts.corpus, unk)
        _, diff = bpe_ops.sum_by_key(torch.cat([keys, k2]),
                                     torch.cat([-counts, c2]))
        seen = torch.unique(torch.cat([seen, k2]))
        nbytes += 16 * int(torch.count_nonzero(diff)) + 12
        ops += len(seen) + len(ts.corpus.tokens)
        keys, counts = k2, c2
    check(ts.n_merges == n, "the plain version merges through the window")
    return bound(nbytes / n, ops / n)


def long_corpus(device, out_dir) -> tuple[str, tuple]:
    """The 16 MB long-word corpus (checked against its digest) and its
    flat stream (tokens, word_id, wcount) under the giant config."""
    from shredword_tpu_torch.bench import (LONG_CORPUS_BYTES,
                                           LONG_CORPUS_SHA256,
                                           make_long_corpus)

    corpus = os.path.join(out_dir, "long.txt")
    make_long_corpus(corpus)
    with open(corpus, "rb") as f:
        data = f.read()
    check(len(data) == LONG_CORPUS_BYTES
          and hashlib.sha256(data).hexdigest() == LONG_CORPUS_SHA256,
          "the long-word corpus matches its digest")
    del data
    tokens, word_id, counts = token_arrays(corpus, device, GIANT)
    lens = np.bincount(word_id)
    print(f"[flat] long-word corpus: {LONG_CORPUS_BYTES} bytes, "
          f"{len(lens)} unique words ({int((lens > 64).sum())} over 64 "
          f"bytes, the longest {int(lens.max())}), stream N {len(tokens)}")
    return corpus, (tokens, word_id, counts[word_id])


def flat_cases(device) -> int:
    """F1 against its plain version, call by call, on every seeded stream
    of tests/torch_flat_cases.py; returns the largest difference."""
    from torch_flat_cases import FLAT_CASES, flat_corpus

    err = 0
    for case, (ckw, target, n_prev, unk, minf) in sorted(FLAT_CASES.items()):
        for steps in (7, 64):
            e, n, *_ = flat_both(flat_corpus(**ckw), device, target=target,
                                   n_prev=n_prev, unk=unk, minf=minf,
                                   steps=steps)
            print(f"[flat] {case}: {n} merges in calls of {steps}, max "
                  f"|F1 - plain| = {e}")
            check(e == 0 and n > 0, f"F1 == plain on {case}")
            err = max(err, e)
    return err


def phase_flat(device, out_dir, corpus, arrays) -> tuple[int, dict]:
    """F1 against its plain version, then the long-word slice; returns
    F1's launches in the slice's train() and its kernels-line timing."""
    from shredword_tpu_torch.ops import _kernels, bpe_ops

    err = flat_cases(device)
    target = GIANT_VOCAB - 256
    kw = dict(unk=GIANT["unk_id"], minf=GIANT["min_pair_freq"])
    e, n, ms_k, ms_p, visited = flat_both(
        arrays, device, target=TIMED_MERGES, steps=TIMED_MERGES, **kw)
    check(e == 0 and n == TIMED_MERGES, "F1 == plain, first 128 merges")
    err = max(err, e)
    cost = flat_cost(arrays, device, TIMED_MERGES)
    print(f"[flat] first {n} merges at vocab {GIANT_VOCAB}: F1 "
          f"{ms_k / n:.6f} ms/merge (bound {cost['bound_ms']:.8f}, "
          f"{cost['bound_by']}), plain {ms_p / n:.4f} ms/merge, max "
          f"|F1 - plain| = {e}; the passes visit {visited / n:.2f} "
          f"chunks of 32 words per merge")

    # the slice, through the public API
    reset_counts()
    timer = Timed(_kernels.flat_train, keep=True)
    _kernels.flat_train = timer
    try:
        n, secs, raw, peak, model, vocab_b = train_and_save(
            corpus, out_dir, GIANT_VOCAB, device, "auto", GIANT,
            tag="_long")
    finally:
        _kernels.flat_train = timer.fn
    launches = _kernels.flat_train.launches
    calls = len(timer.events)
    print(f"[flat] slice: BPETrainer(vocab {GIANT_VOCAB}) on the long-word "
          f"corpus: {n} merges, train {secs:.4f} s ({raw / 1e6 / secs:.3f} "
          f"MB/s), {launches} F1 launches in {calls} calls, whole run "
          f"{timer.ms() / n:.6f} ms per merge (CUDA events around each "
          f"call, its readback included), peak device memory "
          f"{peak / 1e9:.3f} GB")
    check(n == target, "the slice learns every merge")
    check(launches == calls > 0, "the slice ran F1, one launch per call")
    fs = timer.outs[-1].corpus
    del timer.outs[:-1]
    print(f"[flat] slice: the passes visit {fs.visited / n:.2f} chunks of "
          f"32 words per merge over the whole run ({-(-fs.n_words // 32)} "
          f"chunks)")
    # the final compaction and the copy to the host, as train() ends
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    final = bpe_ops.final_corpus(fs)
    final.tokens.cpu().numpy()
    final.word_id.cpu().numpy()
    print(f"[flat] slice: final compaction and copy to the host "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock; "
          f"{len(final.tokens)} live tokens)")
    del fs, final, timer.outs[:]
    _kernels.flat_train = _kernels.flat_train_plain
    try:
        pn, psecs, _, _, pmodel, pvocab = train_and_save(
            corpus, out_dir, GIANT_VOCAB, device, "auto", GIANT,
            tag="_long_plain")
    finally:
        _kernels.flat_train = timer.fn
    print(f"[flat] the plain flat engine on the card: {pn} merges in "
          f"{psecs:.4f} s ({psecs / pn * 1e3:.4f} ms per merge)")
    check(model == pmodel and vocab_b == pvocab,
          "the slice's bytes == the plain flat engine's")
    print(f"[flat] slice .model/.vocab == the plain flat engine's over "
          f"the whole run ({CARD})")
    return launches, dict(max_abs_err=err, ms=ms_k / TIMED_MERGES,
                          plain_ms=ms_p / TIMED_MERGES, **cost,
                          library_ms=None)


# ---------------------------------------------------------------------
# phase 20
# ---------------------------------------------------------------------

BIG_MERGES_JAX = 15772      # the JAX package's BPETrainer run (BASELINE.md)


def big_corpus() -> str:
    """The 1 GB corpus of BASELINE config 2 (bench.ensure_big_corpus:
    reused from the bench's directory when it is there with its known
    bytes, written otherwise), checked against its digest."""
    from shredword_tpu_torch import bench

    t0 = time.perf_counter()
    path, reused = bench.ensure_big_corpus()
    made_s = time.perf_counter() - t0
    size, digest = os.path.getsize(path), bench._sha256(path)
    print(f"[config2] corpus {path}: {size} bytes, sha256 {digest} "
          f"({'reused' if reused else 'generated'} in {made_s:.1f} s)")
    check(size == bench.BIG_CORPUS_BYTES
          and digest == bench.BIG_CORPUS_SHA256,
          "the config 2 corpus matches its digest")
    return path


def config2_layers(corpus, out_dir, device) -> dict:
    """BASELINE config 2 through the public API, load_corpus -> train ->
    save, with each host layer on the host clock: load_corpus (the
    native scan and dedup, then the arrays and coverage), the int32
    guard, _token_arrays, the giant layout (build_giant_layout, whose
    chunk width must be 2048), the upload, the initial tables
    (init_tables, the device synchronized after it), K3's call loop
    (drive_calls: the wrapper's enqueue and the records' readback; CUDA
    events around each call give K3's device time), the final corpus
    (the lazy copy back in save) and the rest of save.  The launch
    counts are set to 0 just before train() and read just after.
    Returns its merges, K3 launches, layout, .model/.vocab bytes and
    flat stream."""
    from shredword_tpu_torch import BPETrainer
    from shredword_tpu_torch.bench import BIG, giant_layouts
    from shredword_tpu_torch.ops import _kernels, bpe_giant

    clock = HostClock(device)
    seen: dict = {}
    patches = [(bpe_giant, "giant_train", False),
               (bpe_giant, "build_giant_layout", False),
               (bpe_giant, "init_tables", True),
               (bpe_giant, "drive_calls", False)]
    t = BPETrainer(target_vocab_size=GIANT_VOCAB, backend="cuda",
                   device=device, **BIG)
    arrays = t._token_arrays

    def token_arrays():
        seen["arrays"] = out = arrays()
        return out

    k3 = Timed(_kernels.giant_train_step, keep=True)
    with giant_layouts() as built:
        saved = [getattr(m, name) for m, name, _ in patches]
        try:
            t._ingest = clock.wrap("arrays and coverage", t._ingest)
            t0 = time.perf_counter()
            t.load_corpus(corpus)
            clock.add("load_corpus", time.perf_counter() - t0)
            t._token_arrays = clock.wrap("_token_arrays", token_arrays)
            for (m, name, sync), fn in zip(patches, saved):
                setattr(m, name, clock.wrap(name, fn, sync))
            _kernels.giant_train_step = k3
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            t0 = time.perf_counter()
            n = t.train()
            torch.cuda.synchronize(device)
            train_s = time.perf_counter() - t0
            launches = _kernels.giant_train_step.launches
            peak = torch.cuda.max_memory_allocated(device)
            t._final_fn = clock.wrap("final corpus", t._final_fn)
            mp, vp = (os.path.join(out_dir, f"big.{x}")
                      for x in ("model", "vocab"))
            t0 = time.perf_counter()
            t.save(mp, vp)
            clock.add("save", time.perf_counter() - t0)
            raw = t._arrays.total_raw_bytes
            n_words = t._arrays.n_words
        finally:
            _kernels.giant_train_step = k3.fn
            for (m, name, _), fn in zip(patches, saved):
                setattr(m, name, fn)
            t.destroy()
    s = clock.secs
    lay = built[-1]
    (L, W), NC = lay.tw.shape, lay.presT.shape[1]
    cw = W // NC
    tokens = seen["arrays"][0]
    k3_ms = k3.ms()
    layers = {
        "int32 guard, routing": train_s - s["_token_arrays"]
        - s["giant_train"],
        "_token_arrays": s["_token_arrays"],
        "layout (build_giant_layout)": s["build_giant_layout"],
        "upload": s["giant_train"] - s["build_giant_layout"]
        - s["init_tables"] - s["init_tables wait"] - s["drive_calls"],
        "init_tables (host)": s["init_tables"],
        "init_tables (device wait)": s["init_tables wait"],
        "K3 call loop (enqueue, records' readback)": s["drive_calls"]}
    print(f"[config2] BPETrainer(vocab {GIANT_VOCAB}, min_pair_freq "
          f"{BIG['min_pair_freq']}, coverage {BIG['character_coverage']}, "
          f"unk {BIG['unk_id']}) on {raw} bytes: {n_words} unique words, "
          f"stream N {len(tokens)}; layout L {L}, W {W}, NC {NC} ("
          f"{-(-lay.n_words // cw)} used), chunk width {cw}")
    print(f"[config2] auto: {n} merges (the JAX package's BPETrainer: "
          f"{BIG_MERGES_JAX}), train() {train_s:.4f} s, "
          f"{raw / 1e6 / train_s:.4f} MB/s, peak device memory "
          f"{peak / 1e9:.3f} GB, {launches} K3 launches in "
          f"{len(k3.events)} calls, K3 {k3_ms:.2f} ms on the card over the "
          f"run ({k3_ms / n:.6f} ms per merge, CUDA events), mean n_refresh "
          f"{mean_refresh(k3.outs):.3f} ({CARD})")
    del k3.outs[:]
    print(f"[config2] load_corpus {s['load_corpus']:.4f} s (native scan "
          f"and dedup {s['load_corpus'] - s['arrays and coverage']:.4f} s, "
          f"arrays and coverage {s['arrays and coverage']:.4f} s); train() "
          f"{train_s:.4f} s layer by layer:")
    for name, sec in layers.items():
        print(f"[config2]   {name}: {sec:.4f} s ({sec / train_s:.3f})")
    print(f"[config2] save {s['save']:.4f} s, of which the final corpus "
          f"(the lazy copy back) {s['final corpus']:.4f} s")
    check(launches > 0 and launches == len(k3.events),
          "config 2 ran K3, one launch per call")
    check(cw == 2048, "config 2's giant layout has chunk width 2048")
    check(n > 0, "config 2 learns merges")
    with open(mp, "rb") as f, open(vp, "rb") as g:
        model, vocab_b = f.read(), g.read()
    return dict(merges=n, launches=launches, layout=lay, model=model,
                vocab=vocab_b, arrays=seen["arrays"])


def phase_config2(device, out_dir) -> tuple[dict, dict]:
    """Phase 20: BASELINE config 2 on the card: the auto path layer by
    layer (K3 at chunk width 2048), engine="flat" on the same corpus (F1;
    bytes == the auto path's), K3 against its plain version for the
    first 128 merges on the auto path's layout, and F1 against its plain
    version for the first 128 merges of its stream, each timed with its
    bound.  Returns the kernels-line records of K3 and F1 here."""
    from shredword_tpu_torch.bench import BIG
    from shredword_tpu_torch.ops import _kernels

    corpus = big_corpus()
    run = config2_layers(corpus, out_dir, device)
    lay, model, vocab_b = run.pop("layout"), run["model"], run["vocab"]
    tokens, word_id, counts = run.pop("arrays")

    # the flat engine on the same corpus
    reset_counts()
    f1 = Timed(_kernels.flat_train)
    _kernels.flat_train = f1
    try:
        fn, fsecs, _, fpeak, fmodel, fvocab = train_and_save(
            corpus, out_dir, GIANT_VOCAB, device, "flat", BIG, tag="_big")
    finally:
        _kernels.flat_train = f1.fn
    f1_launches = _kernels.flat_train.launches
    print(f"[config2] engine=\"flat\": {fn} merges, train() {fsecs:.4f} s, "
          f"peak device memory {fpeak / 1e9:.3f} GB, {f1_launches} F1 "
          f"launches in {len(f1.events)} calls, F1 {f1.ms() / fn:.6f} ms "
          f"per merge over the run (CUDA events around each call)")
    check(f1_launches > 0 and f1_launches == len(f1.events),
          "config 2's flat engine ran F1, one launch per call")
    check(fn == run["merges"] and fmodel == model and fvocab == vocab_b,
          "config 2: giant (K3) == flat (F1) .model/.vocab bytes")
    print("[config2] auto (K3) .model/.vocab == engine=\"flat\" (F1)")

    # K3 against its plain version at width 2048
    gkw = dict(unk=BIG["unk_id"], min_freq=BIG["min_pair_freq"],
               merges=TIMED_MERGES, steps=TIMED_MERGES)
    err, ms_k, ms_p, n, refresh = run_giant_both(lay, GIANT_VOCAB, device,
                                                 **gkw)
    check(err == 0 and n == TIMED_MERGES,
          "K3 == plain at chunk width 2048, first 128 merges of config 2")
    cost = giant_cost(lay, giant_state(lay, GIANT_VOCAB, BIG["unk_id"],
                                       device), 0, n, cfg=BIG)
    print(f"[config2] K3 at layout {tuple(lay.tw.shape)} (cw "
          f"{lay.tw.shape[1] // lay.presT.shape[1]}): first {n} merges, "
          f"kernel {ms_k / n:.6f} ms/merge (bound {cost['bound_ms']:.8f}, "
          f"{cost['bound_by']}), plain {ms_p / n:.4f} ms/merge, mean "
          f"n_refresh {refresh:.3f}, max |kernel - plain| = {err}")
    k3 = dict(max_abs_err=err, ms=ms_k / n, plain_ms=ms_p / n, **cost,
              library_ms=None)

    # F1 against its plain version on the config's stream
    arrays = (tokens, word_id, counts[word_id])
    e, n, fms_k, fms_p, visited = flat_both(
        arrays, device, target=TIMED_MERGES, steps=TIMED_MERGES,
        unk=BIG["unk_id"], minf=BIG["min_pair_freq"])
    check(e == 0 and n == TIMED_MERGES,
          "F1 == plain, first 128 merges of config 2")
    fcost = flat_cost(arrays, device, TIMED_MERGES, cfg=BIG)
    print(f"[config2] F1 on the stream of {len(tokens)} tokens: first {n} "
          f"merges, F1 {fms_k / n:.6f} ms/merge (bound "
          f"{fcost['bound_ms']:.8f}, {fcost['bound_by']}), plain "
          f"{fms_p / n:.4f} ms/merge, max |F1 - plain| = {e}; the passes "
          f"visit {visited / n:.2f} chunks of 32 words per merge ({CARD})")
    flat = dict(max_abs_err=e, ms=fms_k / n, plain_ms=fms_p / n, **fcost,
                library_ms=None)
    return (dict(k3, launches=run["launches"]),
            dict(flat, launches=f1_launches))


# ---------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------

BENCH_TIMEOUT = 900
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}     # bench.py's


def phase_bench(corpus) -> None:
    """python -m shredword_tpu_torch.bench on this corpus, in a fresh
    process on the card: exit 0, bench.py's four keys last with a value
    and vs_baseline above 0, and the engines' cross-check on its
    standard error, which is echoed."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "shredword_tpu_torch.bench",
                        "--corpus", corpus], capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT, cwd=ROOT)
    secs = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        print(line if line.startswith("[bench]") else f"[bench] {line}")
    check(r.returncode == 0, f"the bench exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    check(bool(lines), "the bench printed its line")
    out = json.loads(lines[-1])
    print(f"[bench] its line: {lines[-1]}")
    check(set(out) == BENCH_KEYS and out["metric"] == "train_mb_s"
          and out["unit"] == "MB/s", "the bench's line has bench.py's keys")
    check(out["value"] > 0 and out["vs_baseline"] > 0,
          "the bench's value and vs_baseline are above 0")
    check("device engine cross-check: hist == giant == flat" in r.stderr,
          "the bench's cross-check held")
    print(f"[bench] phase 18: python -m shredword_tpu_torch.bench in "
          f"{secs:.1f} s ({CARD})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))   # the seeded lattices
    import torch.distributed as dist

    from shredword_tpu_torch.bench import (CORPUS_BYTES, CORPUS_SHA256,
                                           make_corpus)
    from shredword_tpu_torch.ops import bpe_giant, bpe_hist
    from shredword_tpu_torch.parallel import multihost

    device = torch.device("cuda", 0)
    card, clocked = phase_env()
    with open(os.path.join(ROOT, "tests", "golden", "bench_v768.json")) as f:
        golden = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        make_corpus(corpus)
        with open(corpus, "rb") as f:
            data = f.read()
        digest = hashlib.sha256(data).hexdigest()
        print(f"[env] corpus: {len(data)} bytes, sha256 {digest}")
        check(len(data) == CORPUS_BYTES and digest == CORPUS_SHA256,
              "the corpus is the JAX bench's")
        enc_text = data[:ENCODE_CHARS].decode()
        del data
        bench_layout = bpe_hist.build_layout(
            *token_arrays(corpus, device, HEADLINE), 64)
        timing = phase_kernel_vs_plain(device, bench_layout)
        launches = {}
        launches[768], model_768, _ = phase_main_path(corpus, tmp, 768,
                                                      device, golden=golden)
        launches[4096], *fused_4096 = phase_main_path(corpus, tmp, 4096,
                                                      device)
        giant_layout = bpe_giant.build_giant_layout(
            *token_arrays(corpus, device, GIANT), GIANT_VOCAB)
        timing[GIANT_VOCAB] = phase_giant_vs_plain(device, giant_layout)
        launches[GIANT_VOCAB], model_giant, vocab_giant = phase_main_path(
            corpus, tmp, GIANT_VOCAB, device, cfg=GIANT,
            kernel="giant_train_step")
        long_txt, long_arrays = long_corpus(device, tmp)
        launches["flat"], timing["flat"] = phase_flat(device, tmp, long_txt,
                                                      long_arrays)
        config2 = phase_config2(device, tmp)
        torch.cuda.empty_cache()
        # the merges that phases 3, 4 and 6 trained, for phase 13
        merges = {768: merges_of(model_768), 4096: merges_of(fused_4096[0]),
                  GIANT_VOCAB: merges_of(model_giant)}
        phase_main_path(corpus, tmp, 768, device, engine="giant",
                        kernel="giant_train_step", golden=golden)
        # the world-size-1 NCCL group of phases 7, 8 and 11
        multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1,
                             rank=0)
        try:
            setup = first_collective(device)
            phase_profile(corpus, device)
            timing["step"] = phase_step_vs_plain(device, bench_layout,
                                                 sparse=False)
            timing["sparse"] = phase_step_vs_plain(device, bench_layout,
                                                   sparse=True)
            launches["sparse"] = phase_sparse_train(corpus, device)
            launches["step"] = phase_sharded(corpus, tmp, device, golden,
                                             fused_4096, setup)
        finally:
            dist.destroy_process_group()
        phase_clocks(device, clocked, bench_layout, giant_layout,
                     long_arrays)
        phase_encode_vs_plain(device, enc_text.encode(), merges)
        encode = {v: phase_encode_main(device, enc_text, m, v)
                  for v, m in merges.items()}
        pretok, launches["gpt_starts"] = phase_pretok(device, enc_text)
        phase_uni_vs_plain(device)
        phase_uni_overflow(device, tmp)
        unigram = phase_uni_slabs(device, corpus)
        uni_launches = phase_uni_main(device, corpus,
                                      enc_text[:UNI_ENCODE_CHARS], tmp)
        uni_card = phase_uni_1024(device, corpus)
        phase_uni_sharded(device, corpus, uni_card)
        phase_cli(corpus, tmp, golden, enc_text, uni_card.pieces, device)
        # phase 15: the row-sharded giant engine (G1) and sharded flat
        multihost.initialize(f"tcp://localhost:{free_port()}", world_size=1,
                             rank=0)
        try:
            first_collective(device)
            g1_err = phase_g1_vs_plain(device, tmp)
            timing["g1"] = phase_g1_timed(
                device, token_arrays(corpus, device, GIANT))
        finally:
            dist.destroy_process_group()
        timing["g1"]["max_abs_err"] = max(g1_err,
                                          timing["g1"]["max_abs_err"])
        launches["g1"] = phase_sharded_giant_main(corpus, tmp, device,
                                                  (model_giant, vocab_giant))
        phase_sharded_giant_gloo(corpus, tmp, device)
        phase_bench(corpus)
    src = "shredword_tpu_torch/csrc/"
    rows = [("hist_fused_train@v768", "hist_fused.cu", 768),
            ("hist_fused_train@v4096", "hist_fused.cu", 4096),
            (f"giant_train@v{GIANT_VOCAB}", "giant.cu", GIANT_VOCAB),
            ("hist_sharded_train@v768", "hist_step.cu", "step"),
            ("hist_sparse_train@v768", "hist_step.cu", "sparse"),
            (f"giant_sharded_train@v{GIANT_VOCAB}", "giant_sharded.cu",
             "g1")]
    kernels = [dict(name=name, route="cuda", source=src + f,
                    replaces=TPU_KERNEL[key], launches=launches[key],
                    **timing[key]) for name, f, key in rows]
    kernels += [dict(name=f"encode@v{v}", route="cuda", source=src
                     + "encode.cu", replaces=TPU_KERNEL["encode"], **rec)
                for v, rec in encode.items()]
    kernels += [dict(name=f"unigram_{k}", route="cuda",
                     source=src + "unigram.cu",
                     replaces=TPU_KERNEL[f"unigram_{k}"],
                     launches=uni_launches[k], **unigram[k])
                for k in ("fb", "viterbi")]
    kernels.append(dict(name="gpt_starts", route="cuda",
                        source=src + "pretok.cu",
                        replaces=TPU_KERNEL["gpt_starts"],
                        launches=launches["gpt_starts"], **pretok))
    kernels.append(dict(name=f"flat_train@long v{GIANT_VOCAB}", route="cuda",
                        source=src + "flat.cu", replaces=F1_SOURCE,
                        launches=launches["flat"], **timing["flat"]))
    kernels += [dict(name=f"{name}@config2 v{GIANT_VOCAB}", route="cuda",
                     source=src + f, replaces=replaces, **rec)
                for (name, f, replaces), rec in zip(
                    (("giant_train", "giant.cu", TPU_KERNEL[GIANT_VOCAB]),
                     ("flat_train", "flat.cu", F1_SOURCE)), config2)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
