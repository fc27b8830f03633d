"""Golden digest of the headline training configuration.

Trains the JAX package's flat engine on the CPU over the corpus that
``bench.make_corpus`` writes (vocab 768, min_pair_freq 50, coverage
0.9999, unk_id -1) and records the merge count and the SHA-256 of the
saved ``.model``/``.vocab`` in ``bench_v768.json`` beside this file.
Any engine of either package must reproduce these bytes exactly.

Slow (several minutes on a CPU), so it is not part of the test suite:

    JAX_PLATFORMS=cpu python tests/golden/bench_v768_gen.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "bench_v768.json")

CONFIG = {"target_vocab_size": 768, "unk_id": -1,
          "character_coverage": 0.9999, "min_pair_freq": 50}


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main() -> None:
    sys.path.insert(0, ROOT)
    import bench
    from shredword_tpu.models.bpe import BPETrainer

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        bench.make_corpus(corpus)
        t = BPETrainer(**CONFIG, backend="tpu", engine="flat")
        t.load_corpus(corpus)
        n = t.train()
        n_words = t._arrays.n_words
        raw = t._arrays.total_raw_bytes
        mp, vp = os.path.join(tmp, "m.model"), os.path.join(tmp, "m.vocab")
        t.save(mp, vp)
        t.destroy()
        out = {"corpus": "bench.make_corpus(path, raw_mb=16, seed=1234)",
               "config": CONFIG, "engine": "shredword_tpu flat, cpu",
               "unique_words": int(n_words), "raw_bytes": int(raw),
               "merges": int(n), "model_sha256": sha256(mp),
               "vocab_sha256": sha256(vp)}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
