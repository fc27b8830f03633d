"""BPETrainer of the PyTorch port.

Same public API and outputs as ``shredword_tpu.models.bpe.BPETrainer``
(``load_corpus`` / ``load_corpus_bytes`` / ``load_corpora``, ``train``,
``save``, checkpoints, ``merges``/``merge_freqs``/``token_frequencies``).
The host side of that class (native corpus ingestion, coverage and unk
mapping, checkpoint replay through the native encoder, the lazy final
corpus, serialization) imports no JAX and is inherited as it is; this
class replaces the device part:

  backend "cuda"  device engines on ``device`` (default "cuda"):
                  engine "auto"/"hist" -> the fused hist kernel for
                  vocab <= 4096 and the giant kernel above it, up to
                  32768 (auto falls to flat when the table engines
                  decline the corpus); "giant" -> the giant kernel at
                  any vocab; "flat" -> the sort-based stream engine.
                  Sharded training is not ported yet and raises.
  backend "cpu"   the native faithful engine, as in the JAX package.

On a CPU device the table engines run their kernels' plain PyTorch
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from shredword_tpu.errors import ConfigError, TrainingError
from shredword_tpu.models import bpe as _host
from shredword_tpu.utils import logging as log

from ..config import BPEConfig
from ..ops import bpe_giant, bpe_hist, bpe_ops


class BPETrainer(_host.BPETrainer):
    def __init__(self, target_vocab_size: int = 8192, unk_id: int = 0,
                 character_coverage: float = 0.995,
                 min_pair_freq: int = 2000, mesh=None, device="cuda",
                 **kwargs):
        config = BPEConfig(
            target_vocab_size=target_vocab_size, unk_id=unk_id,
            character_coverage=character_coverage,
            min_pair_freq=min_pair_freq, **kwargs).validate()
        self.device = torch.device(device)
        if (config.backend == "cuda" and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise ConfigError(
                "backend='cuda' needs a CUDA device and none is available; "
                "pass device='cpu' to run the device engines on the CPU, "
                "or backend='cpu' for the native engine")
        # The inherited constructor sets up the host-side state; its own
        # config knows only the JAX backends, so it is replaced here.
        super().__init__(target_vocab_size, unk_id, character_coverage,
                         min_pair_freq, mesh=mesh,
                         **{**kwargs, "backend": "cpu"})
        self.config = config

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
        if self.mesh is not None or cfg.shards > 1:
            raise TrainingError(
                "sharded training is not ported to shredword_tpu_torch "
                "yet (see ROADMAP.md); train on one device")
        tokens, word_id, wcount, n_prev = self._replay_for_resume(
            tokens, word_id, wcount)

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
        counts = np.minimum(self._arrays.counts,
                            np.iinfo(np.int32).max).astype(np.int32)
        cb, steps = self._table_checkpoint_cb(n_prev)
        kw = dict(target_merges=target, unk_id=cfg.unk_id,
                  min_pair_freq=cfg.min_pair_freq, progress_cb=cb,
                  lazy_final=True, n_prev_merges=n_prev, device=self.device)
        with log.Timer("train", nbytes=self._arrays.total_raw_bytes) as t:
            if engine == "giant":
                out = bpe_giant.giant_train(
                    tokens, word_id, counts,
                    steps_per_call=4096 if steps is None else steps, **kw)
            else:
                out = bpe_hist.hist_train(tokens, word_id, counts,
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
                ts = bpe_ops.train_loop(ts, cfg.unk_id, cfg.min_pair_freq,
                                        target_merges=target,
                                        max_steps=chunk)
                n_after = ts.n_merges
                log.progress("Completed %d/%d merges (stream %d)", n_after,
                             target, len(ts.corpus.tokens))
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
        self._final_tokens = ts.corpus.tokens.cpu().numpy()
        self._final_word_id = ts.corpus.word_id.cpu().numpy()
        self._trained = True
        log.info("Training completed: %d merges performed. (%.2f s, flat "
                 "engine)", n_merges - n_prev, t.elapsed)
        return n_merges - n_prev
