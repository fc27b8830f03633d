"""Whole runs of every cell on the CPU at a size a test holds: the
harness's look for a card skipped, the port's plain versions in the
kernels' place.  A sound run comes out correct, with and without the
trace; a run with the timed path broken underneath, and the control (the
reference with the tie rule broken), come out not correct."""

from __future__ import annotations

import numpy as np
import pytest

from helpers_portbench import bench, tiny_bench
from portbench import compare, control, reference
from portbench.run import execute, read_json

CELLS = [w["name"] for w in bench()["workloads"]]
SEED = 2 ** 31 + 11         # above 32 signed bits, as the driver's are


def _execute(tmp_path, cell, trace=False):
    result, checks = execute(tiny_bench(tmp_path), cell, SEED, 0.5, trace,
                             device="cpu")
    return result, {n: v for n, v, _ in checks}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell, trace):
    result, checks = _execute(tmp_path, cell, trace)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench()[kind]
            if cell in m.get("workloads", [cell])}
    got = set(result["metrics"])
    # a CPU run has no device memory, trace or launch counter: those
    # readers give nothing
    assert got <= want
    host = {n for n in want
            if n.split(".")[0] not in ("peak_device_gb", "train_host_ms",
                                       "launches_per_job",
                                       "kernel_ms_per_job",
                                       "merge_roofline", "device_idle_pct")}
    assert host <= got and (trace or "setup_s" in got)
    if trace:
        assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])


def test_one_rank_group_mix_is_correct(tmp_path):
    """The ``train-mesh1`` mix, which no cell uses yet, on a cell made
    for the test: every job's trainer over a one-rank process group."""
    b = tiny_bench(tmp_path)
    cell = dict(b["workloads"][0], name="mesh-test", traffic="train-mesh1")
    b["workloads"].append(cell)
    result, checks = execute(b, "mesh-test", SEED, 0.5, False,
                             device="cpu")
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= 1


def _unchanged(orig):
    def train(self, max_merges=None):
        return orig(self, max_merges=0)
    return train


def _half_loaded(orig):
    def load(self, data):
        return orig(self, data[: len(data) // 2])
    return load


def _altered(orig):
    def train(self, max_merges=None):
        out = orig(self, max_merges)
        self._merges = self._merges.copy()
        self._merges[-1] = self._merges[-1][::-1]
        return out
    return train


FAULTS = {"state_unchanged": ("train", _unchanged),
          "half_the_corpus": ("load_corpus_bytes", _half_loaded),
          "answer_altered": ("train", _altered)}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                          fault):
    from shredword_tpu_torch import BPETrainer

    method, wrap = FAULTS[fault]
    monkeypatch.setattr(BPETrainer, method,
                        wrap(getattr(BPETrainer, method)))
    result, checks = _execute(tmp_path, cell)
    assert not result["correct"], checks
    assert result["failed"] == result["attempted"] >= 1


@pytest.mark.parametrize("conf", bench()["configs"],
                         ids=lambda c: c["name"])
def test_control_is_not_correct(tmp_path, conf):
    cfg = read_json(tiny_bench(tmp_path) and str(
        tmp_path / f"{conf['name']}.json"))
    for seed in (1, 2, SEED):
        checks, _ = control.control_checks(cfg, seed)
        assert any(v > lim for _, v, lim in checks), (seed, checks)


def test_comparison_counts_each_difference():
    data = b"ab ab abc abc abc bc bc ab\n" * 3
    ref = reference.train(data, 262, -1, 1.0, 2)
    same = compare.combine([compare.job_diffs(
        ref, ref.merges, ref.merge_freqs, ref.model, ref.vocab)])
    assert [v for _, v, _ in same] == [0, 0, 0, 0]
    short = compare.job_diffs(ref, ref.merges[:-1], ref.merge_freqs,
                              ref.model, ref.vocab + b"x")
    assert short["merges_diff"] == 1 and short["vocab_diff"] == 1
    assert short["freqs_diff"] == 0 and short["model_diff"] == 0
    freqs = np.array(ref.merge_freqs)
    freqs[0] += 1
    assert compare.job_diffs(ref, ref.merges, freqs, ref.model,
                             ref.vocab)["freqs_diff"] == 1
