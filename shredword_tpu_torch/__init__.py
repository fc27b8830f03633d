"""shredword_tpu_torch — the BPE trainer of shredword_tpu on PyTorch and
CUDA (NVIDIA Hopper).

``BPETrainer`` keeps the JAX package's API and gives byte-identical
``.model``/``.vocab`` files; its merge loop runs as a hand-written CUDA
kernel on a CUDA device (``csrc/hist_fused.cu`` up to vocab 4096,
``csrc/giant.cu`` up to 32768), or as that kernel's plain PyTorch version
on the CPU.  Sharded training runs over ``torch.distributed``
(``parallel/``).  The package stands alone: it keeps its own host layer
(native corpus loader and faithful trainer under ``runtime/``,
serialization, checkpoints, errors, logging) and imports neither JAX
nor the JAX package.
"""

from .config import BPEConfig
from .models.bpe import BPETrainer

__all__ = ["BPETrainer", "BPEConfig"]
