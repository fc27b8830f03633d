"""Sharded BPE and Unigram training over a ``torch.distributed`` group:
the JAX package's ``shredword_tpu.parallel``, whose ``make_mesh`` and
``sharded_train_loop`` have no counterpart here (``mesh.process_group``
plays their part).  The names load at first use (PEP 562), so importing
this package imports none of its modules."""

import importlib

# name -> the module that defines it (None: the name is a module)
_EXPORTS = {"ShardedCorpus": "train", "shard_corpus": "train",
            "sharded_train": "train", "sharded_hist_train": "hist",
            "sharded_giant_train": "giant", "multihost": None,
            "unigram": None}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module = importlib.import_module(f".{_EXPORTS[name] or name}", __name__)
    return module if _EXPORTS[name] is None else getattr(module, name)
