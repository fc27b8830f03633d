"""Every cell on the card for a few seconds, as the benchmark's command
runs it, untraced and traced: the run exits 0, its last line is the
result, correct, on a card of its own kind.  Skips where there is no
card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from helpers_portbench import bench
from portbench.run import ROOT

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    cmd = bench()["command"] + ["--workload", cell, "--seed",
                                str(2 ** 31 + 101), "--seconds", "3",
                                "--trace", str(trace)]
    cmd[0] = sys.executable if cmd[0].startswith("python") else cmd[0]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench()[kind]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
