"""BPETrainer of the PyTorch port.

Same public API and outputs as ``shredword_tpu.models.bpe.BPETrainer``
(``load_corpus`` / ``load_corpus_bytes`` / ``load_corpora``, ``train``,
``save``, checkpoints, ``merges``/``merge_freqs``/``token_frequencies``).
Pipeline:

  1. host: native corpus ingestion (``runtime/``, threaded dedup) and
     coverage/unk mapping
  2. device: one of the engines below on ``device``
  3. host: serialization; the final merged corpus is materialized only
     when a consumer (``token_frequencies``, ``save``) first needs it

Backends:

  backend "cuda"  device engines on ``device`` (default "cuda"):
                  engine "auto"/"hist" -> the fused hist kernel for
                  vocab <= 4096 and the giant kernel above it, up to
                  32768 (auto falls to flat when the table engines
                  decline the corpus); "giant" -> the giant kernel at
                  any vocab; "flat" -> the flat stream engine (F1,
                  ``csrc/flat.cu``, on a CUDA device).
                  ``mesh`` (a 1-D ``DeviceMesh`` or a ``ProcessGroup``)
                  or ``shards=N`` (the default ``torch.distributed``
                  group, of world size N) trains data-parallel: the
                  sharded hist engine to vocab 4096, then the
                  row-sharded giant engine to 65536, then the sharded
                  flat engine (any vocab, any word length).
  backend "cpu"   the native faithful engine, as in the JAX package.

Ties break to the lexicographically smallest pair on the device
engines; ``tie_break="faithful"`` runs the native engine, whose outputs
byte-match the reference binary.  On a CPU device the table engines run
their kernels' plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import serialization
from ..config import BPEConfig, resolve_device
from ..errors import TrainingError
from ..ops import _kernels, bpe_giant, bpe_hist, bpe_ops
from ..parallel import giant as par_giant
from ..parallel import hist as par_hist
from ..parallel import mesh as par_mesh
from ..parallel import train as par_train
from ..runtime import native
from ..utils import logging as log

_BASE_VOCAB = 256


class BPETrainer:
    def __init__(self, target_vocab_size: int = 8192, unk_id: int = 0,
                 character_coverage: float = 0.995,
                 min_pair_freq: int = 2000, mesh=None, device="cuda",
                 **kwargs):
        self.config = BPEConfig(
            target_vocab_size=target_vocab_size, unk_id=unk_id,
            character_coverage=character_coverage,
            min_pair_freq=min_pair_freq, **kwargs).validate()
        self.device = (resolve_device(device)
                       if self.config.backend == "cuda"
                       else torch.device(device))
        # data-parallel training: a 1-D DeviceMesh or a ProcessGroup;
        # alternatively shards=N in the config uses the default group
        self.mesh = mesh
        self._corpus: native.NativeCorpus | None = None
        self._faithful: native.FaithfulTrainer | None = None
        self._arrays: native.CorpusArrays | None = None
        self._keep: np.ndarray | None = None
        self._merges = np.zeros((0, 2), dtype=np.int32)
        self._merge_freqs = np.zeros(0, dtype=np.int64)
        self.__final_tokens: np.ndarray | None = None
        self.__final_word_id: np.ndarray | None = None
        self._final_fn = None   # lazy materializer (device -> host)
        self._trained = False

    # The table engines leave the merged corpus on the device; the copy
    # to the host happens only when a consumer first touches the arrays.
    @property
    def _final_tokens(self) -> np.ndarray | None:
        self._materialize_final()
        return self.__final_tokens

    @_final_tokens.setter
    def _final_tokens(self, value) -> None:
        self._final_fn = None
        self.__final_tokens = value

    @property
    def _final_word_id(self) -> np.ndarray | None:
        self._materialize_final()
        return self.__final_word_id

    @_final_word_id.setter
    def _final_word_id(self, value) -> None:
        # clear the lazy materializer in BOTH setters: assigning either
        # array must not be silently overwritten by a later _final_fn run
        self._final_fn = None
        self.__final_word_id = value

    def _materialize_final(self) -> None:
        if self._final_fn is not None:
            fn, self._final_fn = self._final_fn, None
            self.__final_tokens, self.__final_word_id = fn()

    # ------------------------------------------------------------------
    # corpus
    # ------------------------------------------------------------------

    def _faithful_order(self) -> bool:
        # The cpu backend runs the faithful engine, whose tie-breaks are
        # corpus-order artifacts; keep the reference word order so its
        # output is reference-identical regardless of tie_break.
        return (self.config.tie_break == "faithful"
                or self.config.backend == "cpu")

    def load_corpus(self, path: str) -> None:
        with log.Timer("load_corpus") as t:
            self._corpus = native.NativeCorpus.from_file(
                path, faithful_order=self._faithful_order())
            self._ingest()
        log.info("Loaded corpus: %d unique words, %d occurrences, "
                 "%.1f MB raw (%.1f MB/s)", self._arrays.n_words,
                 self._arrays.total_occurrences,
                 self._arrays.total_raw_bytes / 1e6,
                 self._arrays.total_raw_bytes / 1e6 / max(t.elapsed, 1e-9))

    def load_corpus_bytes(self, data: bytes) -> None:
        self._corpus = native.NativeCorpus.from_bytes(
            data, faithful_order=self._faithful_order())
        self._ingest()

    def load_corpora(self, paths: list[str]) -> None:
        """Train on several corpus files at once (deduplicated jointly).

        The reference documents calling load_corpus repeatedly for this
        (UserBPE.md "Multiple Corpus Training") but its implementation
        discards all but the last corpus; here load_corpus replaces by
        design and load_corpora provides the documented capability."""
        chunks = []
        for p in paths:
            with open(p, "rb") as f:
                chunks.append(f.read())
            if chunks[-1] and not chunks[-1].endswith(b"\n"):
                chunks.append(b"\n")
        self.load_corpus_bytes(b"".join(chunks))

    def __enter__(self) -> "BPETrainer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.destroy()

    def _ingest(self) -> None:
        if self._faithful is not None:   # stale vs the new corpus
            self._faithful.free()
            self._faithful = None
        self._arrays = self._corpus.arrays()
        keep, n_kept, n_unique = self._corpus.coverage(
            self.config.character_coverage)
        self._keep = keep
        log.debug("Character histogram: %d unique, keeping %d", n_unique,
                  n_kept)

    def _token_arrays(self):
        """Flat (tokens, word_id, wcount) int32 arrays with unk applied."""
        arr = self._arrays
        tokens = arr.word_bytes.astype(np.int32)
        unk = np.where(~self._keep[arr.word_bytes])[0]
        tokens[unk] = self.config.unk_id
        lengths = np.diff(arr.offsets)
        word_id = np.repeat(
            np.arange(arr.n_words, dtype=np.int32), lengths)
        wcount = self._word_counts()[word_id]
        return tokens, word_id, wcount

    def _word_counts(self) -> np.ndarray:
        """Per-word occurrence counts, clipped to int32."""
        return np.minimum(self._arrays.counts,
                          np.iinfo(np.int32).max).astype(np.int32)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self, max_merges: int | None = None) -> int:
        if self._arrays is None:
            raise TrainingError("load_corpus must be called before train")
        cfg = self.config
        if cfg.backend == "cpu" or cfg.tie_break == "faithful":
            if len(self._merges) > 0 and not self._trained:
                raise TrainingError(
                    "checkpoint resume needs the device engines "
                    "(backend='cuda', tie_break='lex'): the faithful "
                    "engine's tie-break state cannot be reconstructed "
                    "mid-training")
            return self._train_cpu_or_faithful(max_merges)
        return self._train_device(max_merges)

    def _train_cpu_or_faithful(self, max_merges) -> int:
        # tie_break="faithful" requires the reference's heap/hash iteration
        # artifacts (docs/CONFORMANCE.md §2), which only the native engine
        # reproduces; it is used regardless of backend.
        cfg = self.config
        if self._faithful is None:
            self._faithful = native.FaithfulTrainer(
                cfg.target_vocab_size, cfg.unk_id,
                cfg.character_coverage, cfg.min_pair_freq)
            self._faithful.load(self._corpus)
        t = self._faithful   # kept alive: train() continues incrementally
        limit = -1 if max_merges is None else max_merges
        if cfg.checkpoint_path and cfg.checkpoint_every:
            n = 0
            while True:
                step = cfg.checkpoint_every
                if limit >= 0:
                    step = min(step, limit - n)
                    if step <= 0:
                        break
                got = t.train(step)
                n += got
                ckpt.save_checkpoint(
                    cfg.checkpoint_path, merges=t.merges(),
                    merge_freqs=t.merge_freqs().astype(np.int64),
                    config=cfg)
                if got < step:
                    break
        else:
            n = t.train(limit)
        self._merges = t.merges()
        self._merge_freqs = t.merge_freqs().astype(np.int64)
        self._final_tokens, self._final_word_id = t.tokens()
        self._trained = True
        log.info("Training completed: %d merges performed.", n)
        return n

    def _train_device(self, max_merges) -> int:
        cfg = self.config
        target = cfg.target_merges
        if max_merges is not None:
            target = min(target, len(self._merges) + max_merges)
        # Device engines count in int32.  The exact bound: a pair's count
        # is at most the corpus pair mass, sum of count * (len - 1).
        lens64 = np.diff(self._arrays.offsets)
        pair_mass = int(
            (self._arrays.counts.astype(np.uint64)
             * np.maximum(lens64 - 1, 0).astype(np.uint64)).sum())
        if int(self._arrays.counts.max(initial=0)) >= 2**31 or \
                pair_mass >= 2**31:
            raise TrainingError(
                "corpus pair counts exceed the device engines' int32 "
                "range; use backend='cpu' (64-bit counts)")
        tokens, word_id, wcount = self._token_arrays()
        if len(tokens) == 0 or target <= 0:
            self._trained = True
            self._final_tokens = tokens
            self._final_word_id = word_id
            log.info("Training completed: 0 merges performed.")
            return 0
        group = None
        if self.mesh is not None or cfg.shards > 1:
            # before the replay: a missing process group is a config error
            group = par_mesh.process_group(self.mesh, cfg.shards)
        tokens, word_id, wcount, n_prev = self._replay_for_resume(
            tokens, word_id, wcount)
        if group is not None:
            return self._train_sharded(group, tokens, word_id, wcount,
                                       target, n_prev)

        if cfg.engine == "giant":
            out = self._train_table("giant", tokens, word_id, target, n_prev)
            if out is None:
                raise TrainingError(
                    "giant engine requested but the corpus/vocab is "
                    "outside its envelope (vocab > 32768, a word > 64 "
                    "tokens, or unk_id >= 256)")
            return out
        if cfg.engine in ("auto", "hist"):
            out = self._train_table("hist", tokens, word_id, target, n_prev)
            if out is not None:
                return out
            if cfg.engine == "hist":
                raise TrainingError(
                    "hist engine requested but the corpus/vocab does not "
                    "fit its layout (a word longer than 64 tokens; above "
                    "vocab 4096, vocab > 32768 or unk_id >= 256)")
            log.info("table engines: a word is longer than their layout "
                     "takes (64 tokens), or above vocab 4096 the vocab or "
                     "unk_id is outside the giant engine's envelope; using "
                     "the flat engine")
        return self._train_flat(tokens, word_id, wcount, target, n_prev)

    def _train_table(self, engine, tokens, word_id, target,
                     n_prev: int = 0) -> int | None:
        """Table engine "hist" (ops/bpe_hist.py, which routes vocab
        above 4096 to the giant engine) or "giant" (ops/bpe_giant.py);
        None if the corpus does not fit.  On resume the caller has
        already replayed n_prev merges into `tokens`."""
        cfg = self.config
        cb, steps = self._table_checkpoint_cb(n_prev)
        kw = dict(target_merges=target, unk_id=cfg.unk_id,
                  min_pair_freq=cfg.min_pair_freq, progress_cb=cb,
                  lazy_final=True, n_prev_merges=n_prev, device=self.device)
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            if engine == "giant":
                out = bpe_giant.giant_train(
                    tokens, word_id, self._word_counts(),
                    steps_per_call=4096 if steps is None else steps, **kw)
            else:
                out = bpe_hist.hist_train(tokens, word_id,
                                          self._word_counts(),
                                          max_steps_per_call=steps, **kw)
            if out is None:
                return None
        if -(-(256 + target) // 128) * 128 > bpe_hist.MAX_V:
            engine = "giant"          # the engine that actually ran
        return self._finish_table_engine(*out, n_prev, t.elapsed, engine)

    def _train_flat(self, tokens, word_id, wcount, target,
                    n_prev: int) -> int:
        cfg = self.config
        ts = bpe_ops.train_init(
            bpe_ops.make_state(tokens, word_id, wcount, self.device),
            cfg.target_merges, n_prev_merges=n_prev)
        chunk = cfg.merges_per_device_call
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            while True:
                n_before = ts.n_merges
                # F1 on a CUDA device, its plain version on the CPU
                ts = _kernels.flat_train(ts, cfg.unk_id, cfg.min_pair_freq,
                                         target_merges=target,
                                         max_steps=chunk)
                n_after = ts.n_merges
                log.progress("Completed %d/%d merges (stream %d)", n_after,
                             target, bpe_ops.stream_length(ts.corpus))
                if cfg.checkpoint_path and cfg.checkpoint_every and \
                        n_after // cfg.checkpoint_every \
                        > n_before // cfg.checkpoint_every:
                    self._write_checkpoint(ts, n_prev)
                if ts.done or n_after >= target or n_after == n_before:
                    break
        n_merges = ts.n_merges
        self._merges = np.concatenate(
            [self._merges[:n_prev], ts.merges[n_prev:n_merges]])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev],
             ts.merge_freqs[n_prev:n_merges].astype(np.int64)])
        final = bpe_ops.final_corpus(ts.corpus)
        self._final_tokens = final.tokens.cpu().numpy()
        self._final_word_id = final.word_id.cpu().numpy()
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, flat "
                 "engine)", n_merges - n_prev, t.elapsed)
        return n_merges - n_prev

    def _train_sharded(self, group, tokens, word_id, wcount, target,
                       n_prev: int) -> int:
        """Data-parallel training over a torch.distributed group, as the
        JAX package routes it: the sharded hist engine (parallel/hist.py,
        vocab <= 4096), then the row-sharded giant engine
        (parallel/giant.py, vocab <= 65536), then the sharded flat engine
        (parallel/train.py; S1 on the card), each taking what the one
        before declines.
        Merge sequences are bit-identical to single-device training.
        Resume: the caller has already replayed n_prev merges into
        `tokens`."""
        cfg = self.config
        kw = dict(mesh=group, target_merges=target, unk_id=cfg.unk_id,
                  min_pair_freq=cfg.min_pair_freq, n_prev_merges=n_prev,
                  device=self.device)
        counts = self._word_counts()
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            engine = "hist"
            out = par_hist.sharded_hist_train(tokens, word_id, counts, **kw)
            if out is None:       # above vocab 4096: the row-sharded table
                engine = "giant"
                out = par_giant.sharded_giant_train(tokens, word_id, counts,
                                                    **kw)
            if out is None:       # outside every table engine's layout
                engine = "flat"
                out = par_train.sharded_train(tokens, word_id, wcount, **kw)
        merges, freqs = out
        self._merges = np.concatenate(
            [self._merges[:n_prev], merges.astype(np.int32)])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev], freqs.astype(np.int64)])
        self._final_tokens = None
        self._final_word_id = None
        self._set_final_replay(self._merges)
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, "
                 "sharded %s engine%s, %d shards)", len(merges), t.elapsed,
                 engine, " (S1)" if engine == "flat" else "", group.size())
        return len(merges)

    def _replay_for_resume(self, tokens, word_id, wcount):
        """Checkpoint resume (any device engine, sharded or not): replay
        the learned merges onto the fresh corpus with the native encoder
        (exact: same rank order and left-to-right overlap semantics as
        training), then continue with re-counted pairs, mirroring the
        reference's bpe_init-after-merge resumability (bpe.cpp:171-185).
        New ids continue at 256 + n_prev.  Returns (tokens, word_id,
        wcount, n_prev)."""
        n_prev = len(self._merges)
        if not n_prev:
            return tokens, word_id, wcount, 0
        lengths = np.bincount(word_id, minlength=self._arrays.n_words)
        offsets = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        enc = native.NativeEncoder(self._merges)
        tokens, out_off = enc.apply_merges(tokens, offsets)
        enc.free()
        word_id = np.repeat(
            np.arange(self._arrays.n_words, dtype=np.int32),
            np.diff(out_off))
        wcount = self._word_counts()[word_id]
        log.info("Resumed from %d merges; replayed corpus has %d "
                 "tokens", n_prev, len(tokens))
        return tokens, word_id, wcount, n_prev

    def _set_final_replay(self, merges: np.ndarray) -> None:
        """Lazy final corpus: replay the learned merges onto the raw
        dedup stream with the native encoder."""
        arr = self._arrays
        keep = self._keep
        unk_id = self.config.unk_id

        def final_fn():
            tokens = arr.word_bytes.astype(np.int32)
            unk = np.where(~keep[arr.word_bytes])[0]
            tokens[unk] = unk_id
            offsets = arr.offsets.astype(np.int64)
            if len(merges):
                enc = native.NativeEncoder(merges)
                tokens, offsets = enc.apply_merges(tokens, offsets)
                enc.free()
            word_id = np.repeat(np.arange(arr.n_words, dtype=np.int32),
                                np.diff(offsets))
            return tokens.astype(np.int32), word_id

        self._final_fn = final_fn

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _write_checkpoint(self, ts, n_prev: int) -> None:
        n = ts.n_merges
        merges = np.concatenate(
            [self._merges[:n_prev], ts.merges[n_prev:n].astype(np.int32)])
        freqs = np.concatenate(
            [self._merge_freqs[:n_prev],
             ts.merge_freqs[n_prev:n].astype(np.int64)])
        ckpt.save_checkpoint(self.config.checkpoint_path, merges=merges,
                             merge_freqs=freqs, config=self.config)
        log.debug("checkpoint: %d merges -> %s", n,
                  self.config.checkpoint_path)

    def save_checkpoint(self, path: str) -> None:
        """Write a resumable checkpoint of the merges learned so far."""
        ckpt.save_checkpoint(path, merges=self._merges,
                             merge_freqs=self._merge_freqs,
                             config=self.config)

    def load_checkpoint(self, path: str) -> int:
        """Load a checkpoint; the next train() resumes after its merges
        (corpus must be loaded; it is replayed on resume).  Returns the
        number of merges restored."""
        _, merges, freqs = ckpt.load_checkpoint(path)
        self._merges = merges.astype(np.int32)
        self._merge_freqs = freqs.astype(np.int64)
        self._trained = False
        return len(merges)

    def _table_checkpoint_cb(self, n_prev: int):
        """(cb, steps) for the table engines' progress callbacks.  The
        engines report only NEW merges; the checkpoint must carry the
        full sequence, so the replayed prefix is prepended."""
        cfg = self.config
        if not (cfg.checkpoint_path and cfg.checkpoint_every):
            return None, None
        prev_m = self._merges[:n_prev].astype(np.int32)
        prev_f = self._merge_freqs[:n_prev].astype(np.int64)

        def cb(merges, freqs):
            ckpt.save_checkpoint(
                cfg.checkpoint_path,
                merges=np.concatenate([prev_m, merges.astype(np.int32)]),
                merge_freqs=np.concatenate([prev_f,
                                            freqs.astype(np.int64)]),
                config=cfg)

        return cb, cfg.checkpoint_every

    def _finish_table_engine(self, merges, freqs, final_fn, n_prev,
                             elapsed, engine: str) -> int:
        self._merges = np.concatenate(
            [self._merges[:n_prev], merges.astype(np.int32)])
        self._merge_freqs = np.concatenate(
            [self._merge_freqs[:n_prev], freqs.astype(np.int64)])
        self._final_tokens = None
        self._final_word_id = None
        self._final_fn = final_fn
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, "
                 "%s engine)", len(merges), elapsed, engine)
        return len(merges)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    @property
    def merges(self) -> np.ndarray:
        return self._merges

    @property
    def merge_freqs(self) -> np.ndarray:
        return self._merge_freqs

    @property
    def num_merges(self) -> int:
        return len(self._merges)

    @property
    def vocab_size(self) -> int:
        return _BASE_VOCAB + self.num_merges

    def token_frequencies(self) -> np.ndarray:
        """Frequency of every vocab id over the final merged corpus
        (reference bpe_save counting pass, bpe.cpp:704-712)."""
        if not self._trained:
            raise TrainingError("train must be called first")
        freqs = np.zeros(self.vocab_size, dtype=np.int64)
        toks = self._final_tokens
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int64).max).astype(np.int64)
        w = counts[self._final_word_id]
        valid = (toks >= 0) & (toks < self.vocab_size)
        np.add.at(freqs, toks[valid], w[valid])
        return freqs

    def save(self, model_path: str, vocab_path: str | None = None) -> None:
        if not self._trained:
            raise TrainingError("train must be called before save")
        serialization.write_model_binary(model_path, self._merges)
        if vocab_path is not None:
            serialization.write_vocab(vocab_path, self._merges,
                                      self.token_frequencies())
            log.info("Saved %d-token vocab to %s and %d merges to %s",
                     self.vocab_size, vocab_path, self.num_merges,
                     model_path)
        else:
            log.info("Saved %d merges to %s", self.num_merges, model_path)

    def destroy(self) -> None:
        if self._faithful is not None:
            self._faithful.free()
            self._faithful = None
        if self._corpus is not None:
            self._corpus.free()
            self._corpus = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
