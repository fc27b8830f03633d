"""Typed errors of the PyTorch port (the same classes as the JAX
package's ``shredword_tpu.errors``, kept as the port's own copy).

The reference mixes recoverable rc codes with hard exit() on OOM/null
(SURVEY.md §5); here every failure surfaces as a typed Python exception.
"""


class ShredError(Exception):
    """Base class for all shredword_tpu_torch errors."""


class CorpusError(ShredError, IOError):
    """Corpus loading/parsing failure."""


class ConfigError(ShredError, ValueError):
    """Invalid configuration."""


class TrainingError(ShredError, RuntimeError):
    """Training failed or was called in an invalid state."""


class SerializationError(ShredError, IOError):
    """Model/vocab serialization failure."""


class EncodeError(ShredError, ValueError):
    """Encoding failure (e.g. disallowed special token in input)."""


class DecodeError(ShredError, ValueError):
    """Decoding failure (e.g. invalid token id)."""
