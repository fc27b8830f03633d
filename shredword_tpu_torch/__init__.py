"""shredword_tpu_torch — the BPE and Unigram trainers and tokenizers of
shredword_tpu on PyTorch and CUDA (NVIDIA Hopper).

``BPETrainer`` keeps the JAX package's API and gives byte-identical
``.model``/``.vocab`` files; its merge loop runs as a hand-written CUDA
kernel on a CUDA device (``csrc/hist_fused.cu`` up to vocab 4096,
``csrc/giant.cu`` up to 32768), or as that kernel's plain PyTorch version
on the CPU.  Sharded training runs over ``torch.distributed``
(``parallel/``).  ``Tokenizer`` keeps the JAX package's encode/decode/
save/load API and ids; its device encoder's merge loop is
``csrc/encode.cu`` (lane groups per chunk).  ``UnigramTrainer`` and
``UnigramTokenizer`` keep the JAX package's Unigram API, pieces and
model file; their lattice forward-backward (the EM E-step) and Viterbi
are ``csrc/unigram.cu`` (sixteen lanes per word), and sharded EM runs over
``torch.distributed``.  The package stands alone: it keeps its own host
layer (native corpus loader, faithful trainer and CPU encoder under
``runtime/``, pre-tokenization, serialization, checkpoints, errors,
logging) and imports neither JAX nor the JAX package.
"""

from .config import BPEConfig, UnigramConfig
from .errors import (ConfigError, CorpusError, DecodeError, EncodeError,
                     SerializationError, ShredError, TrainingError)
from .models.bpe import BPETrainer
from .models.unigram import UnigramTokenizer, UnigramTrainer
from .tokenizer import (Tokenizer, build_vocab, get_stats, merge,
                        render_token)

__version__ = "0.1.0"       # the JAX package's

__all__ = [
    "BPETrainer", "Tokenizer", "BPEConfig", "render_token",
    "get_stats", "merge", "build_vocab",
    "UnigramTrainer", "UnigramTokenizer", "UnigramConfig",
    "ShredError", "CorpusError", "ConfigError", "TrainingError",
    "SerializationError", "EncodeError", "DecodeError",
    "__version__",
]
