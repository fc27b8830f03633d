"""Multi-process training setup: the torch.distributed layer.

Counterpart of ``shredword_tpu/parallel/multihost.py`` (which drives
``jax.distributed``).  One process per device; the sharded engines
reduce their integer count deltas with ``all_reduce``, so the result is
bit-identical whatever the number of ranks.  Typical launch, one
process per card:

    torchrun --nproc-per-node N train.py

    # train.py
    from shredword_tpu_torch import BPETrainer
    from shredword_tpu_torch.parallel import multihost
    multihost.initialize()                  # env:// from torchrun, NCCL
    t = BPETrainer(..., shards=multihost.world_size(),
                   device=f"cuda:{multihost.local_rank()}")

Nothing here picks the CPU on its own: NCCL and "cuda" are the
defaults, and ranks on the CPU pass ``backend="gloo"`` and
``global_mesh("cpu")``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..errors import ConfigError
from ..utils import logging as log
from . import mesh as _mesh


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str = "nccl") -> None:
    """Initialize the default process group on ``backend`` (NCCL unless
    the caller asks for another; ranks on the CPU pass ``"gloo"``);
    without the other arguments the ``env://`` variables that torchrun
    sets.  NCCL without a card raises ConfigError.  Idempotent."""
    if dist.is_initialized():
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise ConfigError("backend='nccl' needs a CUDA device and none is "
                          "available; pass backend='gloo' for ranks on "
                          "the CPU")
    kw = {} if world_size is None else dict(world_size=world_size,
                                            rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kw)
    if backend == "nccl":     # NCCL's collectives run on the current card
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    log.info("distributed: rank %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)


def world_size() -> int:
    return dist.get_world_size()


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK; the global rank when it is not set)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def global_mesh(device_type: str = "cuda"):
    """1-D DeviceMesh (dim name "data") over every rank of the
    initialized default group, on ``device_type`` ("cuda" unless the
    caller passes "cpu" for ranks on the CPU); the port's counterpart of
    the JAX package's ``make_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (_mesh._world_size(),),
                            mesh_dim_names=("data",))


def host_shard(n_items: int) -> slice:
    """This rank's contiguous slice of an n_items-long work list (corpus
    files, shards): an equal split by rank.  Kept for parity with the
    JAX package's ``host_shard``; no port engine calls it yet (the
    sharded corpus loader will)."""
    p, n = dist.get_rank(), dist.get_world_size()
    per = -(-n_items // n)
    return slice(p * per, min((p + 1) * per, n_items))
