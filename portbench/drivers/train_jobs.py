"""Training jobs back to back on one corpus made from the seed.

A job is what a user of the trainer runs: a fresh ``BPETrainer``,
``load_corpus_bytes``, a synchronise, ``train()``, ``save()`` of the
``.model`` and ``.vocab`` into the run's temporary directory, a
synchronise, ``destroy()``.  ``train()`` cannot run twice from one load
(a second call continues from the merges it has), so every job loads
again.

The traffic file's keys: ``mesh_world``, 0 for a trainer on one device,
or 1 for a trainer over a one-rank NCCL process group that set-up makes
(the sharded API's path on one card).

Set-up makes the corpus and runs one job whose outputs are not kept.
The window runs jobs until ``--seconds`` have passed since its start and
keeps each job's merges, counts and files.  The check works out the
same job in the plain reference and compares every job with it.
"""

from __future__ import annotations

import glob
import os
import shutil
import socket
import tempfile
import time

from .. import compare, reference
from ..run import ROOT, BenchError, Job, load_module

TRAINER_KEYS = ("target_vocab_size", "unk_id", "character_coverage",
                "min_pair_freq")
SEED_MOD = 2 ** 32      # numpy's RandomState takes seeds below 2**32


def trainer_kwargs(config: dict) -> dict:
    return {k: config[k] for k in TRAINER_KEYS}


def make_corpus(config: dict, seed: int) -> bytes:
    """The configuration's corpus for ``seed``, in memory."""
    gen = load_module("generators", config["corpus_generator"])
    return gen.make(config["corpus_mb"], seed % SEED_MOD,
                    **config.get("corpus_params", {}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def built_libraries() -> set:
    """The libraries in the port's build directory, which the first run
    of a checkout fills."""
    return set(glob.glob(os.path.join(ROOT, "shredword_tpu_torch", "build",
                                      "*.so")))


def setup(run) -> None:
    before = built_libraries()
    t0 = time.perf_counter()
    import torch  # noqa: F401  (set-up pays the import)
    try:
        from shredword_tpu_torch import BPETrainer
    except ImportError as e:
        raise BenchError(f"the program under test does not import: {e}")

    run.state["trainer"] = BPETrainer
    t1 = time.perf_counter()
    run.state["corpus"] = make_corpus(run.config, run.seed)
    t2 = time.perf_counter()
    run.corpus_mb = len(run.state["corpus"]) / 1e6
    run.state["tmp"] = tempfile.mkdtemp(prefix="portbench-")
    run.state["mesh"] = None
    world = run.traffic.get("mesh_world", 0)
    if world:
        if world != 1:
            raise ValueError("one process runs one rank: mesh_world is 1")
        import torch.distributed as dist
        kw = {}
        if run.device.startswith("cuda"):
            torch.cuda.set_device(0)
            kw["device_id"] = torch.device("cuda", 0)
        dist.init_process_group(
            "nccl" if run.device.startswith("cuda") else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0, **kw)
        run.state["mesh"] = dist.group.WORLD
    t3 = time.perf_counter()
    warm(run)
    built = sorted(os.path.basename(p) for p in built_libraries() - before)
    run.setup_parts = {"import_s": t1 - t0, "corpus_s": t2 - t1,
                       "group_s": t3 - t2,
                       "warm_job_s": time.perf_counter() - t3,
                       "built": built}


def _job(run, k: int) -> tuple[Job, dict]:
    """Job k (its files named by k)."""
    tmp = run.state["tmp"]
    paths = (os.path.join(tmp, f"job{k}.model"),
             os.path.join(tmp, f"job{k}.vocab"))
    with run.span("job"):
        t0 = time.perf_counter()
        with run.span("load"):
            tr = run.state["trainer"](**trainer_kwargs(run.config),
                                      mesh=run.state["mesh"],
                                      device=run.device)
            tr.load_corpus_bytes(run.state["corpus"])
            run.sync()
        t1 = time.perf_counter()
        with run.span("train_save"):
            tr.train()
            tr.save(*paths)
            run.sync()
        t2 = time.perf_counter()
        out = {"merges": tr.merges, "freqs": tr.merge_freqs,
               "paths": paths}
        with run.span("destroy"):
            tr.destroy()
        del tr
        t3 = time.perf_counter()
    return Job(t0, t1, t2, t3), out


def warm(run) -> None:
    """One job whose outputs are not kept."""
    _, out = _job(run, -1)
    for p in out["paths"]:
        os.remove(p)


def window(run) -> None:
    if run.device.startswith("cuda"):
        import torch
        run.peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.sync()
    start = time.perf_counter()
    while not run.jobs or time.perf_counter() - start < run.seconds:
        job, out = _job(run, len(run.jobs))
        run.jobs.append(job)
        run.outputs.append(out)
    if run.device.startswith("cuda"):
        import torch
        run.window_peak_bytes = torch.cuda.max_memory_allocated()


def release(run) -> None:
    """Drop what the program made but the outputs."""
    run.state.pop("trainer", None)


def check(run) -> list:
    run.reference = ref = reference.train(run.state["corpus"],
                                          **trainer_kwargs(run.config))
    per_job = []
    for out in run.outputs:
        files = []
        for p in out["paths"]:
            with open(p, "rb") as f:
                files.append(f.read())
            os.remove(p)
        per_job.append(compare.job_diffs(ref, out["merges"], out["freqs"],
                                         *files))
    run.state["per_job"] = per_job
    return compare.combine(per_job)


def failed(run) -> int:
    return sum(1 for d in run.state.get("per_job", ())
               if any(d.values()))


def close(run) -> None:
    shutil.rmtree(run.state.get("tmp", ""), ignore_errors=True)
    if run.state.get("mesh") is not None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        run.state["mesh"] = None
