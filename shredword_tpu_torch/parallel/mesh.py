"""Meshes and process groups for data-parallel training.

Counterpart of ``shredword_tpu/parallel/train.py::make_mesh``.  A JAX
mesh is one controller over many devices; with ``torch.distributed``
every rank is its own process, so a mesh is a 1-D ``DeviceMesh`` (dim
name ``"data"``, ``multihost.global_mesh``) over the ranks of an
initialized process group, and the sharded engines run over its
``ProcessGroup``.  The JAX package's ``mesh_key`` keys compiled
executables; PyTorch compiles nothing here, so it has no counterpart.
"""

from __future__ import annotations

import torch.distributed as dist

from ..errors import ConfigError

_HOW = ("initialize torch.distributed first: launch with torchrun "
        "--nproc-per-node N, or call "
        "shredword_tpu_torch.parallel.multihost.initialize()")


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise ConfigError(f"sharded training needs a torch.distributed "
                          f"process group; {_HOW}")
    return dist.get_world_size()


def process_group(mesh=None, shards: int = 0):
    """The ProcessGroup that sharded training runs over: ``mesh``'s (a
    1-D DeviceMesh or a ProcessGroup), else the default group, whose
    world size must be ``shards``."""
    if mesh is None:
        world = _world_size()
        if world != shards:
            raise ConfigError(
                f"shards={shards} needs a torch.distributed world of "
                f"{shards} ranks, but it has {world}; {_HOW}")
        return dist.group.WORLD
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        if mesh.ndim != 1:
            raise ConfigError(f"sharded training takes a 1-D mesh, got "
                              f"{mesh.ndim} dimensions")
        return mesh.get_group()
    if isinstance(mesh, dist.ProcessGroup):
        return mesh
    raise ConfigError(f"mesh must be a torch DeviceMesh or ProcessGroup, "
                      f"got {type(mesh).__name__}")
