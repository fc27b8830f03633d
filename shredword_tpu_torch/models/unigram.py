"""UnigramTrainer and UnigramTokenizer of the PyTorch port.

Same public API, outputs and model file (``shredword unigram v1``) as
``shredword_tpu.models.unigram``: a SentencePiece-style unigram LM
trainer the reference ships only the groundwork for (its normalizer and
seed enumerator, normalize.cpp:24-59, 215-237).

  1. normalize and split at the U+2581 marker into unique words with
     counts, each word prefixed with the marker
  2. seed vocabulary: all substrings (the reference enumerator's
     semantics) capped to ``seed_size`` by count, plus every byte seen
  3. EM: the E-step is the lattice forward-backward over device-resident
     [L, K, W] piece-id tables (``ops/unigram_ops``), one per slab of
     words, built once and remapped at every prune; on a card it is the
     kernel ``csrc/unigram.cu`` (U1), one launch per slab per round
  4. pruning: keep the pieces whose removal loses the most likelihood
     (each piece segmented without its own arc by the batched Viterbi,
     U2), all single bytes kept, until the target size is reached
  5. encoding: the batched Viterbi (U2) over each input's distinct words

Backends: ``backend="cuda"`` (the default) runs the E-step on ``device``
("cuda" by default; on the CPU the kernel's plain version), and
``backend="cpu"`` the numpy float64 forward-backward, as the JAX
package's "cpu" backend.  ``mesh`` (a 1-D DeviceMesh or a ProcessGroup)
or ``shards=N`` (the default torch.distributed group, of world size N)
shards every slab's words over the ranks (``parallel/unigram.py``); as
in the JAX package, an explicit mesh runs the device E-step whatever the
backend.  The DP is float32 as in the JAX package; the expected counts
are summed in float64.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..config import UnigramConfig, resolve_device
from ..errors import ConfigError, EncodeError, TrainingError
from ..ops import unigram_ops
from ..parallel import mesh as par_mesh
from ..parallel import unigram as par_uni
from ..runtime import native
from ..utils import logging as log

_MARKER = "▁".encode()


def _prep_words(corpus_bytes: bytes, max_word_len: int):
    """Normalize, split at markers, dedup to (words, counts)."""
    norm = native.normalize(corpus_bytes)
    counts: dict[bytes, int] = {}
    for line in norm.split(b"\n"):
        for raw in line.split(_MARKER):
            if not raw:
                continue
            w = (_MARKER + raw)[: max_word_len]
            counts[w] = counts.get(w, 0) + 1
    words = sorted(counts)
    return words, np.asarray([counts[w] for w in words], dtype=np.int64)


class UnigramTrainer:
    """API mirrors BPETrainer: load_corpus / train / save.

    After ``train()``, ``timings`` holds the seconds of its host layers:
    "seed", "tables" (piece tables and their upload), "e_step", "m_step"
    and "prune"."""

    # words per E-step slab: bounds the [L, K, W] piece table (int32) to
    # ~126 MB at L=32, K=15 whatever the corpus size
    EM_SLAB_WORDS = 65536

    def __init__(self, target_vocab_size: int = 8192,
                 seed_size: int = 100_000, max_piece_len: int = 15,
                 max_word_len: int = 32, shrink_factor: float = 0.75,
                 num_em_rounds: int = 2, backend: str = "cuda",
                 device="cuda", mesh=None, shards: int = 0, **kw):
        self.config = UnigramConfig(
            target_vocab_size=target_vocab_size, seed_size=seed_size,
            max_piece_len=max_piece_len, max_word_len=max_word_len,
            shrink_factor=shrink_factor, num_em_rounds=num_em_rounds,
            backend=backend, **kw).validate()
        if shards < 0:
            raise ConfigError("shards must be >= 0")
        # word-sharded EM over a torch.distributed group (the JAX
        # package's mesh); shards=N takes the default group
        self.mesh = mesh
        self.shards = shards
        self._sharded = mesh is not None or shards > 1
        self._device_em = backend == "cuda" or self._sharded
        self.device = (resolve_device(device) if self._device_em
                       else torch.device(device))
        self._words: list[bytes] | None = None
        self._wcounts: np.ndarray | None = None
        self._slabs = None          # device-resident lattice tables
        self.pieces: list[bytes] = []
        self.log_probs: np.ndarray = np.zeros(0, np.float64)
        # quality metrics, set by train(): total corpus log likelihood
        # of the final EM round and its normalizations
        self.final_ll: float = 0.0
        self.final_ll_per_word: float = 0.0
        self.final_ll_per_byte: float = 0.0
        self.timings: dict[str, float] = {}

    # ------------------------------------------------------------------

    def load_corpus(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        self._words, self._wcounts = _prep_words(
            data, self.config.max_word_len)
        self._slabs = None
        log.info("Unigram corpus: %d unique words, %d occurrences",
                 len(self._words), int(self._wcounts.sum()))

    # ------------------------------------------------------------------

    def _timed(self, name: str, t0: float) -> None:
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)

    def _seed(self) -> tuple[list[bytes], np.ndarray]:
        sv = native.SeedVocab()
        try:
            for w, c in zip(self._words, self._wcounts):
                # skip_markers=False: word-boundary pieces (marker-
                # prefixed) must be seedable for the trainer, unlike the
                # reference-parity enumerator surface
                sv.add(w, max_len=self.config.max_piece_len,
                       weight=int(c), skip_markers=False)
            pieces, counts = sv.export(self.config.seed_size)
        finally:
            sv.free()
        # required single bytes: every byte occurring in any word
        seen = set()
        for w in self._words:
            seen.update(w)
        singles = [bytes([b]) for b in sorted(seen)]
        have = set(pieces)
        extra = [s for s in singles if s not in have]
        if extra:
            pieces = pieces + extra
            counts = np.concatenate(
                [counts, np.ones(len(extra), np.int64)])
        return pieces, counts

    def _required(self, pieces: list[bytes]) -> np.ndarray:
        """Mask of pieces that may never be pruned (single bytes)."""
        return np.asarray([len(p) == 1 for p in pieces])

    def _loss_delta_keep(self, pieces, logp, exp_counts) -> np.ndarray:
        """SentencePiece-style loss-delta pruning mask:
        :meth:`_keep_from_loss` of :meth:`_prune_loss`."""
        return self._keep_from_loss(
            pieces, self._prune_loss(pieces, logp, exp_counts))

    def _prune_loss(self, pieces, logp, exp_counts) -> np.ndarray:
        """The likelihood lost by removing each piece (inf: unprunable).

        For each prunable piece p: segment p's own string with the
        current model EXCLUDING the whole-string arc (that one table
        cell masked on the host before the upload; the batched Viterbi's
        scores only).  Removing p re-routes its expected frequency F_p
        through that alternative, so the loss is F_p * (logp_p - alt_p).
        Single bytes and pieces with no alternative are unprunable."""
        cfg = self.config
        loss = np.full(len(pieces), np.inf)
        prunable = np.nonzero(~self._required(pieces))[0]
        lp64 = np.asarray(logp, np.float64)
        for s in range(0, len(prunable), self.EM_SLAB_WORDS):
            idx = prunable[s:s + self.EM_SLAB_WORDS]
            strs = [pieces[i] for i in idx]
            L = max(2, max(len(p) for p in strs))
            table = native.piece_table(strs, pieces, L,
                                       min(cfg.max_piece_len, L))
            wlen = np.asarray([len(p) for p in strs], np.int32)
            # mask the identity arc: row r, start 0, length len - 1
            table[np.arange(len(idx)), 0, wlen - 1] = -1
            alt = unigram_ops.viterbi_scores(
                table, wlen, np.asarray(logp, np.float32),
                device=self._em_device())
            f = exp_counts[idx]
            d = f * (lp64[idx] - alt)
            d = np.where(np.isfinite(alt), d, np.inf)  # no alt: keep
            loss[idx] = d
        return loss

    def _keep_from_loss(self, pieces, loss) -> np.ndarray:
        """Keep the shrink_factor fraction with the largest loss (ties to
        the earlier piece), the single bytes, and every piece whose
        removal makes some string unsegmentable."""
        cfg = self.config
        required = self._required(pieces)
        prunable = np.nonzero(~required)[0]
        keep_n = max(cfg.target_vocab_size,
                     int(len(pieces) * cfg.shrink_factor))
        keep = required.copy()
        slots = keep_n - int(keep.sum())
        if slots > 0:
            order = prunable[np.argsort(-loss[prunable], kind="stable")]
            keep[order[:slots]] = True
        keep[np.isinf(loss) & ~required] = True
        return keep

    def _em_device(self) -> torch.device:
        """Where the lattice kernels run: the trainer's device for the
        device E-step, the CPU (their plain versions) for backend
        "cpu"."""
        return self.device if self._device_em else torch.device("cpu")

    # ------------------------------------------------------------------

    def _group(self):
        return par_mesh.process_group(self.mesh, self.shards)

    def _dev_slab_tables(self, pieces):
        """Device-resident per-slab lattice tables, built once for the
        seed piece set and remapped (a gather on the device) at every
        prune, so the host piece tables and their upload happen once per
        slab for the whole training run."""
        if self._slabs is None:
            L = self.config.max_word_len
            K = self.config.max_piece_len
            wlen = np.asarray([len(w) for w in self._words], np.int32)
            wc = self._wcounts.astype(np.float32)
            group = self._group() if self._sharded else None
            self._slabs = []
            # length-bucketed slabs: a word of length l needs only an
            # [l-tight, K, W] lattice, and short words dominate natural
            # text.  Buckets are L/2 (short) and L (the rest); counts
            # are order-independent, so bucketing is free.
            buckets = ([L // 2, L] if L >= 8 else [L])
            lo = 0
            for b in buckets:
                sel = np.nonzero((wlen > lo) & (wlen <= b))[0]
                lo = b
                for s in range(0, len(sel), self.EM_SLAB_WORDS):
                    idx = sel[s:s + self.EM_SLAB_WORDS]
                    if group is not None:
                        self._slabs.append(par_uni.make_sharded_table(
                            group, self._words, idx, pieces, b,
                            min(K, b), wlen, wc, self.device))
                        continue
                    words_b = [self._words[i] for i in idx]
                    table = native.piece_table(words_b, pieces, b,
                                               min(K, b))
                    self._slabs.append(unigram_ops.make_device_table(
                        table, wlen[idx], wc[idx], self.device))
        return self._slabs

    def _remap_slabs(self, keep: np.ndarray) -> None:
        """Apply a prune to the resident tables: survivors renumber,
        pruned cells become absent (local to each rank, no
        collective)."""
        if self._slabs is None:
            return
        perm = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
        self._slabs = [unigram_ops.remap_device_table(dt, perm)
                       for dt in self._slabs]

    def _e_step(self, pieces, logp):
        """Expected piece counts (float64) and the total log-likelihood.
        The device E-step runs the resident tables (no per-round
        upload); the cpu backend keeps the slab-streamed numpy
        forward-backward."""
        lp = np.asarray(logp, np.float32)
        total = np.zeros(len(pieces), np.float64)
        ll = 0.0
        if self._device_em:
            if self._slabs is None:
                t0 = time.perf_counter()
                self._dev_slab_tables(pieces)
                self._timed("tables", t0)
            t0 = time.perf_counter()
            for dt in self._slabs:
                if self._sharded:
                    c, l = par_uni.sharded_forward_backward(
                        dt, lp, len(pieces), group=self._group())
                else:
                    c, l = unigram_ops.forward_backward_resident(
                        dt, lp, len(pieces))
                total += c
                ll += l
            self._timed("e_step", t0)
            return total, ll
        t0 = time.perf_counter()
        L = self.config.max_word_len
        K = self.config.max_piece_len
        wlen = np.asarray([len(w) for w in self._words], np.int32)
        wc = self._wcounts.astype(np.float32)
        for s in range(0, len(self._words), self.EM_SLAB_WORDS):
            e = min(s + self.EM_SLAB_WORDS, len(self._words))
            table = native.piece_table(self._words[s:e], pieces, L, K)
            c, l = unigram_ops.forward_backward(
                table, wlen[s:e], wc[s:e], lp, len(pieces),
                backend="cpu")
            total += np.asarray(c, np.float64)
            ll += float(l)
        self._timed("e_step", t0)
        return total, ll

    def train(self) -> int:
        if self._words is None:
            raise TrainingError("load_corpus must be called before train")
        cfg = self.config
        self.timings = {}
        t0 = time.perf_counter()
        pieces, counts = self._seed()
        self._timed("seed", t0)
        self._slabs = None          # resident tables track `pieces`
        freq = counts.astype(np.float64)
        logp = np.log(freq / freq.sum())
        log.info("Unigram seed: %d pieces", len(pieces))

        ll = 0.0
        while True:
            for r in range(cfg.num_em_rounds):
                exp_counts, ll = self._e_step(pieces, logp)
                t0 = time.perf_counter()
                tot = exp_counts.sum()
                with np.errstate(divide="ignore"):
                    logp = np.where(exp_counts > 0,
                                    np.log(exp_counts / max(tot, 1e-300)),
                                    -1e30)
                self._timed("m_step", t0)
                log.progress("EM round %d: %d pieces, loss %.4f", r,
                             len(pieces), -ll)
            if len(pieces) <= cfg.target_vocab_size:
                break
            t0 = time.perf_counter()
            keep = self._loss_delta_keep(pieces, logp, exp_counts)
            new_pieces = [p for p, k in zip(pieces, keep) if k]
            if len(new_pieces) == len(pieces):
                log.warning(
                    "unigram prune cannot shrink below %d required "
                    "pieces (target %d); stopping",
                    int(self._required(pieces).sum()),
                    cfg.target_vocab_size)
                self._timed("prune", t0)
                break
            self._remap_slabs(keep)
            pieces = new_pieces
            logp = logp[keep]
            logp -= np.log(np.exp(logp).sum() + 1e-300)
            self._timed("prune", t0)
        self.pieces = pieces
        self.log_probs = logp
        # quality metrics: total corpus log likelihood of the final EM
        # round, and its per-occurrence / per-byte normalizations (word
        # occurrences weight the lattice)
        self.final_ll = float(ll)
        n_occ = float(self._wcounts.sum())
        n_bytes = float((self._wcounts
                         * np.asarray([len(w) for w in self._words],
                                      np.int64)).sum())
        self.final_ll_per_word = self.final_ll / max(n_occ, 1.0)
        self.final_ll_per_byte = self.final_ll / max(n_bytes, 1.0)
        log.info("Unigram training complete: %d pieces "
                 "(corpus LL %.4g, %.4f/word)", len(pieces),
                 self.final_ll, self.final_ll_per_word)
        return len(pieces)

    # ------------------------------------------------------------------

    def save(self, model_path: str) -> None:
        """Text format: 'shredword unigram v1' + piece-hex<TAB>logprob."""
        with open(model_path, "w", encoding="utf-8") as f:
            f.write("shredword unigram v1\n")
            f.write(f"{len(self.pieces)}\n")
            for p, lp in zip(self.pieces, self.log_probs):
                f.write(f"{p.hex()}\t{lp:.17g}\n")

    @classmethod
    def load_model(cls, model_path: str) -> tuple[list[bytes], np.ndarray]:
        with open(model_path, "r", encoding="utf-8") as f:
            header = f.readline().strip()
            if header != "shredword unigram v1":
                raise TrainingError(f"bad unigram model header: {header!r}")
            n = int(f.readline())
            pieces, lps = [], []
            for _ in range(n):
                hx, lp = f.readline().split("\t")
                pieces.append(bytes.fromhex(hx))
                lps.append(float(lp))
        return pieces, np.asarray(lps, np.float64)


class UnigramTokenizer:
    """Viterbi segmentation with a trained unigram model.

    encode() runs the batched Viterbi (``unigram_ops.viterbi``, the
    kernel U2 on a card) over the input's distinct words, one call per
    slab, with a persistent word -> ids memo.  As in the JAX package,
    words longer than ``DEVICE_WORD_CAP`` bytes take the per-word host DP
    (``encode_word``): the lattice layout's bound, not a fallback from a
    failed kernel."""

    DEVICE_WORD_CAP = 64        # device-lattice word length bound
    ENC_SLAB_WORDS = 32768      # bounds the [L, K, W] lookup table

    def __init__(self, pieces: list[bytes], log_probs: np.ndarray,
                 device="cuda"):
        self.pieces = pieces
        self.log_probs = np.asarray(log_probs, np.float64)
        self.device = resolve_device(device)
        self._index = {p: i for i, p in enumerate(pieces)}
        self._max_len = max((len(p) for p in pieces), default=1)
        self._memo: dict[bytes, list[int]] = {}
        # (flat bytes, offsets, n_pieces-at-build) — see decode_bytes
        self._flat: tuple[np.ndarray, np.ndarray, int] | None = None

    @classmethod
    def load(cls, model_path: str, device="cuda") -> "UnigramTokenizer":
        return cls(*UnigramTrainer.load_model(model_path), device=device)

    def encode_word(self, word: bytes) -> list[int]:
        n = len(word)
        best = np.full(n + 1, -math.inf)
        best[0] = 0.0
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        for j in range(1, n + 1):
            for l in range(1, min(self._max_len, j) + 1):
                pid = self._index.get(word[j - l:j])
                if pid is None:
                    continue
                cand = best[j - l] + self.log_probs[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (j - l, pid)
        if not math.isfinite(best[n]):
            raise EncodeError(
                f"word {word!r} cannot be segmented: it contains bytes "
                "absent from the training corpus")
        ids = []
        j = n
        while j > 0:
            j, pid = back[j]
            ids.append(pid)
        return ids[::-1]

    def encode(self, text: str) -> list[int]:
        return self.encode_array(text).tolist()

    def encode_array(self, text: str) -> np.ndarray:
        """encode() returning int32 numpy ids: one native pass splits the
        normalized bytes into words and deduplicates them, only the
        distinct words go to the Viterbi, and the id stream is a native
        memcpy expansion."""
        norm = native.normalize(text.encode())
        inverse, uoff_b, ulen = native.marker_word_dedup(norm)
        if len(inverse) == 0:
            return np.zeros(0, np.int32)
        uniq_words = [_MARKER + norm[o:o + l]
                      for o, l in zip(uoff_b.tolist(), ulen.tolist())]
        self._segment_new(uniq_words)
        parts = [self._memo[w] for w in uniq_words]
        lens = np.fromiter(map(len, parts), np.int64, len(parts))
        flat = np.fromiter((i for u in parts for i in u), np.int32,
                           int(lens.sum()))
        uoff = np.zeros(len(parts) + 1, np.int64)
        np.cumsum(lens, out=uoff[1:])
        total = int(lens[inverse].sum())
        return native.expand_ids(flat, uoff, inverse, total)

    def _segment_new(self, words: list[bytes]) -> None:
        """Viterbi-segment the words not yet memoized (distinct, one call
        per slab); words over DEVICE_WORD_CAP bytes take the host DP."""
        fresh = [w for w in dict.fromkeys(words) if w not in self._memo]
        dev = [w for w in fresh if len(w) <= self.DEVICE_WORD_CAP]
        lp = np.asarray(self.log_probs, np.float32)
        for s in range(0, len(dev), self.ENC_SLAB_WORDS):
            slab = dev[s:s + self.ENC_SLAB_WORDS]
            L = max(2, max(len(w) for w in slab))
            table = native.piece_table(slab, self.pieces, L,
                                       min(self._max_len, L))
            wlen = np.asarray([len(w) for w in slab], np.int32)
            segs = unigram_ops.viterbi(table, wlen, lp, device=self.device)
            self._memo.update(zip(slab, segs))
        for w in fresh:
            if len(w) > self.DEVICE_WORD_CAP:
                self._memo[w] = self.encode_word(w)

    def encode_batch(self, texts: list[str]) -> list[list[int]]:
        """Encode many documents; the Viterbi sees each distinct word
        across the whole batch once (shared memo).  Returns lists of
        ints, the BPE Tokenizer.encode_batch contract."""
        return [a.tolist() for a in self.encode_batch_arrays(texts)]

    def encode_batch_arrays(self, texts: list[str]) -> list[np.ndarray]:
        """encode_batch returning int32 numpy arrays."""
        return [self.encode_array(t) for t in texts]

    def decode_bytes(self, ids) -> bytes:
        """ids -> raw bytes (marker bytes preserved), by the native
        piece expansion the BPE decoder uses."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) == 0:
            return b""
        # keyed on the piece count, so a mutated or extended `pieces`
        # list invalidates it
        if self._flat is None or self._flat[2] != len(self.pieces):
            lens = np.fromiter((len(p) for p in self.pieces), np.int64,
                               len(self.pieces))
            off = np.zeros(len(self.pieces) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            self._flat = (np.frombuffer(b"".join(self.pieces), np.uint8),
                          off, len(self.pieces))
        flat, off = self._flat[:2]
        if (ids < 0).any() or (ids >= len(self.pieces)).any():
            raise EncodeError("invalid piece id in decode")
        total = int((off[ids + 1] - off[ids]).sum())
        return native.expand_bytes(flat, off, ids.astype(np.int32), total)

    def decode(self, ids) -> str:
        data = self.decode_bytes(ids)
        return data.replace(_MARKER, b" ").decode("utf-8", "replace").strip()
