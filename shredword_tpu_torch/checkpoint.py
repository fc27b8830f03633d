"""Mid-training checkpoint / resume (the JAX package's on-disk format:
checkpoints move between the two packages in both directions).

The reference saves only at the end of training (bpe_save) but its C API
is resumable by construction — bpe_merge_batch can stop anywhere and
bpe_init re-counts from the current corpus state (SURVEY.md §5).  This
module makes that the actual subsystem: a checkpoint is the merge table
learned so far (plus config); resume replays the merges onto a freshly
loaded corpus (the fast native encoder applies a partial merge table
exactly) and training continues with re-counted pair frequencies —
mirroring the reference's bpe_init-after-merge semantics.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .errors import SerializationError

MAGIC = "shredword-checkpoint-v1"


def save_checkpoint(path: str, *, merges: np.ndarray,
                    merge_freqs: np.ndarray, config) -> None:
    payload = {
        "magic": MAGIC,
        "config": dataclasses.asdict(config),
        "n_merges": int(len(merges)),
    }
    with open(path, "wb") as f:
        header = json.dumps(payload).encode()
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(np.ascontiguousarray(merges, np.int32).tobytes())
        f.write(np.ascontiguousarray(merge_freqs, np.int64).tobytes())


def load_checkpoint(path: str):
    """Returns (config_dict, merges int32[N,2], merge_freqs int64[N])."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        try:
            payload = json.loads(f.read(hlen))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise SerializationError(f"corrupt checkpoint {path}: {e}")
        if payload.get("magic") != MAGIC:
            raise SerializationError(
                f"{path} is not a shredword checkpoint")
        n = payload["n_merges"]
        merges = np.frombuffer(f.read(n * 8), np.int32).reshape(n, 2)
        freqs = np.frombuffer(f.read(n * 8), np.int64)
    return payload["config"], merges.copy(), freqs.copy()
