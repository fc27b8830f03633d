"""Golden digest of the headline training configuration.

Trains the JAX package's flat engine on the CPU over the corpus that
``bench.make_corpus`` writes (vocab 768, min_pair_freq 50, coverage
0.9999, unk_id -1) and records the merge count and the SHA-256 of the
saved ``.model``/``.vocab`` in ``bench_v768.json`` beside this file.
Any engine of either package must reproduce these bytes exactly.

Slow (several minutes on a CPU), so it is not part of the test suite:

    JAX_PLATFORMS=cpu python tests/golden/bench_v768_gen.py

``--raw-mb 1`` writes ``bench_v768_1mb.json`` instead, the digest of the
1 MB corpus (``make_corpus(path, raw_mb=1)``, about 2 minutes), which
``tests/test_torch_bench.py`` holds the port's bench against.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def out_path(raw_mb: int) -> str:
    name = "bench_v768.json" if raw_mb == 16 else f"bench_v768_{raw_mb}mb.json"
    return os.path.join(HERE, name)

CONFIG = {"target_vocab_size": 768, "unk_id": -1,
          "character_coverage": 0.9999, "min_pair_freq": 50}


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main() -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--raw-mb", type=int, default=16)
    raw_mb = p.parse_args().raw_mb
    sys.path.insert(0, ROOT)
    import bench
    from shredword_tpu.models.bpe import BPETrainer

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        bench.make_corpus(corpus, raw_mb=raw_mb)
        t = BPETrainer(**CONFIG, backend="tpu", engine="flat")
        t.load_corpus(corpus)
        n = t.train()
        n_words = t._arrays.n_words
        raw = t._arrays.total_raw_bytes
        mp, vp = os.path.join(tmp, "m.model"), os.path.join(tmp, "m.vocab")
        t.save(mp, vp)
        t.destroy()
        out = {"corpus": f"bench.make_corpus(path, raw_mb={raw_mb}, "
                         "seed=1234)",
               "config": CONFIG, "engine": "shredword_tpu flat, cpu",
               "unique_words": int(n_words), "raw_bytes": int(raw),
               "merges": int(n), "model_sha256": sha256(mp),
               "vocab_sha256": sha256(vp)}
    with open(out_path(raw_mb), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
