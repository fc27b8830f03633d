"""Configuration for BPE training in the PyTorch port.

The fields, defaults and defaulting rules are those of
``shredword_tpu.config.BPEConfig`` (reference bpe.h:43-48 and
create_trainer, bpe.cpp:124-130).  Only the backends differ: ``"cuda"``
runs the device engines (hist or giant kernel, or flat stream) on the
trainer's torch device, ``"cpu"`` the port's native faithful engine.
"""

from __future__ import annotations

import dataclasses

import torch

from .errors import ConfigError


@dataclasses.dataclass(frozen=True)
class BPEConfig:
    target_vocab_size: int = 8192
    unk_id: int = -1
    character_coverage: float = 0.995
    min_pair_freq: int = 2000

    merges_per_device_call: int = 64    # flat engine: merges between
                                        # progress reports / checkpoints
    compact_every: int = 64             # kept for config parity
    tie_break: str = "lex"              # "lex" | "faithful" (CPU selector)
    backend: str = "cuda"               # "cuda" | "cpu"
    engine: str = "auto"                # "auto" | "hist" | "giant" | "flat"
    checkpoint_path: str | None = None  # mid-training checkpoint file
    checkpoint_every: int = 0           # merges between checkpoints (0=off)
    shards: int = 0                     # data-parallel ranks

    def normalized(self) -> "BPEConfig":
        """Apply reference defaulting rules (bpe.cpp:124-130)."""
        cov = self.character_coverage
        if cov <= 0.0 or cov >= 1.0:
            cov = 0.995
        mpf = self.min_pair_freq
        if mpf == 0:
            mpf = 2000
        return dataclasses.replace(self, character_coverage=cov,
                                   min_pair_freq=mpf)

    def validate(self) -> "BPEConfig":
        if self.target_vocab_size < 256:
            raise ConfigError(
                f"target_vocab_size must be >= 256, got {self.target_vocab_size}")
        if self.min_pair_freq < 0:
            raise ConfigError("min_pair_freq must be >= 0")
        if self.tie_break not in ("lex", "faithful"):
            raise ConfigError(f"unknown tie_break {self.tie_break!r}")
        if self.backend not in ("cuda", "cpu"):
            raise ConfigError(f"unknown backend {self.backend!r}")
        if self.engine not in ("auto", "hist", "giant", "flat"):
            raise ConfigError(f"unknown engine {self.engine!r}")
        if self.shards < 0:
            raise ConfigError("shards must be >= 0")
        return self.normalized()

    @property
    def target_merges(self) -> int:
        return self.target_vocab_size - 256


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``.  The port's entry points run on
    the card unless the caller asks for the CPU: a CUDA device on a host
    that has none raises ConfigError (decided at the call, never at
    import), with no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            f"device {str(device)!r} needs a CUDA device and none is "
            "available; pass device='cpu' to run the device engines on the "
            "CPU, or backend='cpu' for the native engine")
    return dev
