"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root
of the checkout.  Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by name:

* the configuration: the file that ``configs`` names (trainer settings,
  the corpus generator and its size);
* the traffic mix: ``portbench/traffic/<traffic>.json``, whose
  ``driver`` names the module under ``portbench/drivers/`` that sets
  up, runs the window and checks the outputs against the reference;
* each metric: ``portbench/metrics/<name>.py``, whose ``read(run)``
  gives its value or None (the metric is then left out of the line),
  and whose optional ``prepare(run)`` instruments the traced run.

With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
its per-layer metrics, the device's busy seconds and a breakdown.  The
last line of standard output is the result; every number compared with
the reference is printed beside its limit as the last lines of standard
error and under ``checks``, the line's last key.  With no CUDA device,
or fewer than the cell asks for, the run fails and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field

from . import trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "shredword_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
PAUSE_S = 0.5      # idle host time around the traced window


class BenchError(RuntimeError):
    """The run cannot give a result."""


@dataclass
class Job:
    """Host-clock times of one job, in seconds."""

    start: float
    loaded: float        # after load_corpus_bytes and a synchronise
    trained: float       # after train(), save() and a synchronise
    end: float           # after destroy()


@dataclass
class Run:
    """What a run knows: its cell, what the driver records and what the
    metric readers read."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    device: str = "cuda"
    corpus_mb: float = 0.0
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)  # the driver's split
    jobs: list = field(default_factory=list)        # Job, window only
    outputs: list = field(default_factory=list)     # the driver's, a job
    launches: dict = field(default_factory=dict)    # wrapper -> count
    call_s: float = 0.0          # host seconds in instrumented calls
    calls: int = 0
    events: list = field(default_factory=list)      # device (name, s, e) µs
    spans: dict = field(default_factory=dict)       # span -> [(s, e)] µs
    window_us: tuple = (0.0, 0.0)
    peak_bytes: int = 0          # whole run, before the reference
    window_peak_bytes: int = 0
    reference: object = None
    on_close: list = field(default_factory=list)    # undo after the window
    state: dict = field(default_factory=dict)       # the driver's own

    def span(self, name: str):
        """A named span of the traced run (a no-op untraced)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("portbench." + name)

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    if not _NAME.match(name):
        raise BenchError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no {kind} file {path}")
    mod_name = f"portbench.{kind}." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of metric ``name``: ``portbench/metrics/<name>.py``."""
    return load_module("metrics", name)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = read_json(os.path.join(ROOT, conf["file"]))
    if not _NAME.match(cell["traffic"]):
        raise BenchError(f"bad traffic name {cell['traffic']!r}")
    traffic = read_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics that ``workload`` reports with this --trace."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def card() -> tuple[str, str]:
    """(the card's name, its power limit as nvidia-smi reads it)."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        limit = out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def launch_counts() -> dict:
    """Every ``.launches`` counter of the port's loaded modules' functions,
    by ``module.function``."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != "shredword_tpu_torch":
            continue
        for fn_name, fn in list(vars(mod).items()):
            n = getattr(fn, "launches", None) if callable(fn) else None
            if isinstance(n, int) and getattr(fn, "__module__", "") \
                    == mod_name:
                out[f"{mod_name.rsplit('.', 1)[-1]}.{fn_name}"] = n
    return out


def counted_window(run: Run, driver) -> None:
    """The driver's window, with the launches that the wrappers counted
    in it (warm-up jobs left out)."""
    before = launch_counts()
    driver.window(run)
    after = launch_counts()
    run.launches = {k: after[k] - before.get(k, 0) for k in after
                    if after[k] != before.get(k, 0)}


def forbidden_modules() -> list[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda",
            t0: float | None = None) -> tuple[dict, list]:
    """Run the cell once: (the result, the checks as (name, value,
    limit)).  ``device`` other than cuda skips the look for a card (the
    CPU tests drive a run so); the harness itself always asks for cuda."""
    t0 = time.perf_counter() if t0 is None else t0
    cell, config, traffic = cell_parts(bench, workload)
    import torch

    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: the benchmark runs on the "
                             "card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{workload} needs {cell['chips']} CUDA "
                             f"devices, found {torch.cuda.device_count()}")
        name, limit = card()
    else:
        name, limit = device, "none"
    print(f"[portbench] card {name}, power limit {limit}; {workload} "
          f"seed {seed} seconds {seconds} trace {int(trace)}",
          file=sys.stderr)
    run = Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
              cell=cell, config=config, traffic=traffic, device=device)
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: metric_reader(m["name"]) for m in metrics}
    driver = load_module("drivers", traffic["driver"])
    try:
        driver.setup(run)
        if trace:
            for r in readers.values():
                if hasattr(r, "prepare"):
                    r.prepare(run)
        run.setup_s = time.perf_counter() - t0
        print(f"[portbench] set-up {run.setup_s:.3f} s: "
              f"{json.dumps(run.setup_parts)}", file=sys.stderr)
        if trace:
            traced_window(run, driver)
        else:
            counted_window(run, driver)
        for undo in reversed(run.on_close):
            undo()
        run.on_close.clear()
        n = max(len(run.jobs), 1)
        print(f"[portbench] {len(run.jobs)} jobs, a job's mean s: load "
              f"{sum(j.loaded - j.start for j in run.jobs) / n:.4f}, "
              f"train+save {sum(j.trained - j.loaded for j in run.jobs) / n:.4f}, "
              f"destroy {sum(j.end - j.trained for j in run.jobs) / n:.4f}; "
              f"launches {json.dumps(run.launches, sort_keys=True)}",
              file=sys.stderr)
        print("[portbench] train+save s a job: " + " ".join(
            f"{j.trained - j.loaded:.4f}" for j in run.jobs)
            + "; load s: " + " ".join(f"{j.loaded - j.start:.4f}"
                                      for j in run.jobs), file=sys.stderr)
        if device.startswith("cuda"):
            run.peak_bytes = max(run.peak_bytes,
                                 torch.cuda.max_memory_allocated())
        driver.release(run)
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = driver.check(run)
        print(f"[portbench] reference and comparison "
              f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    finally:
        driver.close(run)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    wrong = driver.failed(run)
    correct = bool(run.jobs) and all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": name, "count": cell["chips"],
           "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": correct, "attempted": len(run.jobs),
              "failed": wrong, "metrics": values, "device": dev}
    if trace:
        busy = tr.union_us(tr.clip(run.events, *run.window_us)) / 1e6
        dev["busy_s"] = busy
        dev["window_s"] = (run.window_us[1] - run.window_us[0]) / 1e6
        result["breakdown"] = tr.breakdown(run)
    # set-up in its parts; "built" names the libraries that this run
    # compiled (a checkout's first run), whose set-up counts the build
    result["setup"] = dict(run.setup_parts, setup_s=run.setup_s)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def main(argv=None, t0: float | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    try:
        result, checks = execute(bench, args.workload, args.seed,
                                 args.seconds, bool(args.trace), t0=t0)
    except BenchError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[portbench] the run's process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for n, v, lim in checks:
        print(f"[portbench] check {n} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def traced_window(run: Run, driver) -> None:
    """The window under torch.profiler.  One job first, uncounted, since
    the profiler can drop the device events of a trace's first call;
    then a pause with the device idle, the window, and a pause before
    the trace stops, so no device event of the window is cut off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.warm(run)
        run.sync()
        time.sleep(PAUSE_S)
        run.call_s, run.calls = 0.0, 0
        with run.span("window"):
            counted_window(run, driver)
        time.sleep(PAUSE_S)
        t_read = time.perf_counter()
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            if e.device_type == DeviceType.CPU:
                run.spans.setdefault(e.name[len("portbench."):],
                                     []).append((s, t))
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            # kernels, copies and fills; a record_function range that the
            # program opens is drawn on the device's timeline too, and is
            # no device work
            run.events.append((e.name, s, t))
    print(f"[portbench] trace stopped and read in "
          f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
    (run.window_us,) = run.spans.pop("window", [(0.0, 0.0)])
    for name, spans in run.spans.items():
        run.spans[name] = sorted(s for s in spans
                                 if s[0] >= run.window_us[0])
