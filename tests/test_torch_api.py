"""The port's public surface against the JAX package's: every package's
``__all__``, ``__version__``, ``models.BPETrainer``, ``utils.logging`` and
``utils.Timer``, and the faithful trainer's methods.

The exceptions: ``shredword_tpu.parallel``'s ``make_mesh`` and
``sharded_train_loop`` build a ``jax.sharding.Mesh`` and its loop, and
have no counterpart; ``shredword_tpu_torch.parallel.mesh.process_group``
plays their part."""

import inspect
import os
import subprocess
import sys

import numpy as np

import shredword_tpu
import shredword_tpu_torch
from golden.corpus_gen import small_corpus
from shredword_tpu import models as jax_models
from shredword_tpu import parallel as jax_parallel
from shredword_tpu import utils as jax_utils
from shredword_tpu.runtime import native as jax_native
from shredword_tpu_torch import models, parallel, utils
from shredword_tpu_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_COUNTERPART = {"make_mesh", "sharded_train_loop"}


def test_package_all_and_version():
    assert shredword_tpu_torch.__all__ == shredword_tpu.__all__
    assert shredword_tpu_torch.__version__ == shredword_tpu.__version__
    for name in shredword_tpu.__all__:
        assert hasattr(shredword_tpu_torch, name), name


def test_parallel_all():
    assert parallel.__all__ == [n for n in jax_parallel.__all__
                                if n not in NO_COUNTERPART]
    for name in parallel.__all__:
        got, want = getattr(parallel, name), getattr(jax_parallel, name)
        assert inspect.ismodule(got) == inspect.ismodule(want), name
        assert got.__name__.rsplit(".", 1)[-1] == \
            want.__name__.rsplit(".", 1)[-1]
    assert callable(parallel.mesh.process_group)
    for name in NO_COUNTERPART:
        assert not hasattr(parallel, name)


def test_parallel_loads_its_modules_at_first_use():
    """Importing the parallel package alone imports none of its
    modules (PEP 562), so it adds nothing to a command's start-up."""
    code = """
import sys, types
pkg = types.ModuleType("shredword_tpu_torch")   # without its __init__
pkg.__path__ = ["shredword_tpu_torch"]
sys.modules["shredword_tpu_torch"] = pkg
import shredword_tpu_torch.parallel as p
print(sorted(m for m in sys.modules if m.startswith("shredword_tpu_torch.")))
p.multihost
print("shredword_tpu_torch.parallel.multihost" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout.split("\n")
    assert out[0] == "['shredword_tpu_torch.parallel']"
    assert out[1] == "True"


def test_models_and_utils_exports():
    assert models.BPETrainer is shredword_tpu_torch.BPETrainer
    assert jax_models.BPETrainer is shredword_tpu.BPETrainer
    assert utils.logging.__name__ == "shredword_tpu_torch.utils.logging"
    assert jax_utils.logging.__name__ == "shredword_tpu.utils.logging"
    assert utils.Timer is utils.logging.Timer
    assert set(inspect.signature(utils.Timer).parameters) \
        == set(inspect.signature(jax_utils.Timer).parameters)


def test_faithful_trainer_matches_jax(tmp_path):
    data = small_corpus().encode()
    out = {}
    for mod, tag in ((native, "port"), (jax_native, "jax")):
        t = mod.FaithfulTrainer(300, -1, 0.995, 2)
        t.load(mod.NativeCorpus.from_bytes(data, faithful_order=True))
        t.train()
        t.save(str(tmp_path / f"{tag}.model"), str(tmp_path / f"{tag}.vocab"))
        out[tag] = (t.token_freqs(), t.kept_chars, t.unique_chars)
    (pf, pk, pu), (jf, jk, ju) = out["port"], out["jax"]
    assert pf.dtype == np.uint64 and len(pf) > 256
    np.testing.assert_array_equal(pf, jf)
    assert (pk, pu) == (jk, ju) and 0 < pk <= pu
    for ext in ("model", "vocab"):
        assert (tmp_path / f"port.{ext}").read_bytes() \
            == (tmp_path / f"jax.{ext}").read_bytes()
