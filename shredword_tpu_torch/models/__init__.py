from .bpe import BPETrainer  # noqa: F401
