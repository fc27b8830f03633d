"""The harness's arithmetic on hand-made spans, events and work: the
rates, the union of device intervals, the idle share and the roofline."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import roofline, trace
from portbench.run import Job, Run, load_module


def _run(**kw):
    run = Run(workload="w", seed=1, seconds=1.0, trace=True, cell={},
              config={}, traffic={})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def read(name, run):
    return load_module("metrics", name).read(run)


def test_union_clip_gaps():
    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.union_us(ev) == 25
    assert trace.clip(ev, 8, 21) == [("a", 8, 10), ("b", 8, 15),
                                     ("c", 20, 21)]
    assert trace.gaps(ev, -5, 35) == [(-5, 0), (15, 20), (30, 35)]
    assert trace.union_us(trace.inside(ev, [(0, 4), (12, 24)])) == 4 + 3 + 4
    assert trace.union_us([]) == 0


def test_gap_names():
    spans = {"load": [(0, 10)], "train_save": [(10, 30)],
             "call": [(12, 20)]}
    assert trace.gap_name(spans, 5, 15) == "load>call"
    assert trace.gap_name(spans, 21, 29) == "train_save"
    assert trace.gap_name(spans, 31, 40) == "between_jobs"
    run = _run(spans=spans, events=[("k", 12, 20)], window_us=(0, 40))
    assert trace.breakdown(run) == {
        "device_ops": [["k", 8e-6]],
        "idle_gaps": [["load>train_save", 12e-6],
                      ["train_save>between_jobs", 20e-6]][::-1]}


def test_rates():
    # two jobs of 16 MB: loads of 1 s, train+save of 2 s and 3 s
    jobs = [Job(0.0, 1.0, 3.0, 3.5), Job(3.5, 4.5, 7.5, 8.0)]
    run = _run(jobs=jobs, corpus_mb=16.0)
    assert read("train_mb_s", run) == pytest.approx(32 / 5)
    assert read("job_mb_s", run) == pytest.approx(32 / 8)
    assert read("load_ms", run) == pytest.approx(1000.0)
    run.call_s, run.calls = 3.0, 4
    assert read("train_host_ms", run) == pytest.approx(1000.0)
    run.launches = {"_kernels.giant_train_step": 16}
    assert read("launches_per_job", run) == 8
    assert read("train_mb_s", _run()) is None
    assert read("job_mb_s", _run()) is None


def test_idle_and_kernel_time():
    spans = {"job": [(0, 100), (200, 300)],
             "train_save": [(40, 100), (240, 300)]}
    events = [("k", 50, 90), ("Memcpy HtoD", 90, 95), ("k", 250, 260),
              ("k", 150, 160)]                    # between jobs: not read
    run = _run(spans=spans, events=events)
    # busy 45 + 10 of 120 us of train_save
    assert read("device_idle_pct", run) == pytest.approx(100 * 65 / 120)
    # kernels (copies left out) inside the jobs: 40 + 10 us over 2 jobs
    assert read("kernel_ms_per_job", run) == pytest.approx(0.025)
    assert read("device_idle_pct", _run()) is None
    assert read("kernel_ms_per_job", _run()) is None


def test_roofline():
    ref = SimpleNamespace(n_tokens=1000, initial_pairs=100,
                          changed_pairs=[10, 20], occurrences=[5, 6])
    nbytes, ops = roofline.merge_work(ref)
    assert nbytes == 8 * 1000 + 16 * 100 + 16 * 30 + 12 * 2
    assert ops == 30 + 11
    t, bound = roofline.least_time(nbytes, ops)
    assert bound == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    assert roofline.least_time(0, 67e12) == (1.0, "operations")
    # the share: least time over kernel time, 2 jobs of 1 ms each
    run = _run(spans={"job": [(0, 5000), (5000, 10000)]},
               events=[("k", 0, 1000), ("k", 5000, 6000)], reference=ref)
    assert read("merge_roofline", run) == pytest.approx(
        100 * t / 1e-3)
    run.reference = None
    assert read("merge_roofline", run) is None


def test_peak():
    assert read("peak_device_gb", _run(window_peak_bytes=4_304_626_688)) \
        == pytest.approx(4.304626688)
    assert read("peak_device_gb", _run()) is None
