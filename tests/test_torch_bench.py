"""The port's bench (``python -m shredword_tpu_torch.bench``) on the CPU,
against the JAX side at 1 MB: its corpus is the JAX bench's
``make_corpus`` byte for byte and a file is reused only when it is the
known corpus; its headline run (the kernels' plain versions) saves the
bytes of the JAX package's ``BPETrainer(backend="tpu")`` on the CPU (the
1 MB golden digest, ``tests/golden/bench_v768_1mb.json``, written by
``tests/golden/bench_v768_gen.py --raw-mb 1``: the JAX run takes about
two minutes); its cross-check passes, and raises when one engine's bytes
differ; ``main`` prints bench.py's four keys last, and no JSON line when
a check fails or when there is no card.  The one real ``main`` runs one
timed headline and no warm-up (each train of the plain versions takes
about 13 s at 1 MB on one core); the warm-up and best-of-3 logic is held
by a test with a stand-in trainer."""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shredword_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_1MB = os.path.join(ROOT, "tests", "golden", "bench_v768_1mb.json")
CPU_ARGV = ["--device", "cpu", "--raw-mb", "1", "--no-side"]
KEYS = {"metric", "value", "unit", "vs_baseline"}     # bench.py's line


def _jax_bench():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench as jax_bench
    return jax_bench


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module")
def corpus_1mb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "corpus.txt")
    bench.make_corpus(path, raw_mb=1)
    return path


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One real ``main`` on the CPU at 1 MB, with one timed headline run
    and no warm-up: (exit code, stdout, stderr, the headline's and the
    cross-check's saved bytes, taken from the calls of measure_train and
    check_device_engines inside it, and the corpus main wrote)."""
    seen = {"corpus": str(tmp_path_factory.mktemp("main") / "corpus.txt")}
    real_train, real_check = bench.measure_train, bench.check_device_engines

    def measure_train(corpus, device="cuda", save_to=None):
        out = real_train(corpus, device, save_to=save_to)
        seen["headline"] = bench.read_model(save_to)
        seen["merges"] = out[1]
        return out

    def check_device_engines(corpus, device, work):
        seen["engines"] = real_check(corpus, device, work)
        return seen["engines"]

    out, err = io.StringIO(), io.StringIO()
    threads = torch.get_num_threads()
    # 4 trains of the plain versions (about 55 s on one core): one
    # thread, since several threads each in the test workers beside it
    # oversubscribe the cores and run many times slower
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bench, "WARMUP", 0)
            mp.setattr(bench, "RUNS", 1)
            mp.setattr(bench, "measure_train", measure_train)
            mp.setattr(bench, "check_device_engines", check_device_engines)
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = bench.main(CPU_ARGV + ["--corpus", seen["corpus"]])
    finally:
        torch.set_num_threads(threads)
    return rc, out.getvalue(), err.getvalue(), seen


def test_make_corpus_matches_the_jax_bench(corpus_1mb, tmp_path):
    want = str(tmp_path / "jax.txt")
    _jax_bench().make_corpus(want, raw_mb=1)
    with open(corpus_1mb, "rb") as f, open(want, "rb") as g:
        got, ref = f.read(), g.read()
    assert got == ref and len(got) > 10**6


def _golden_big_corpus():
    """tests/golden/bigcorpus_gen.py, the generator of the JAX package's
    config 2 corpus."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bigcorpus_gen", os.path.join(ROOT, "tests", "golden",
                                      "bigcorpus_gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# one block of 4,000,000 words (15 MB), then two blocks (30 MB): the
# blocks built on threads are written in the order of their draws
@pytest.mark.parametrize("raw_mb", [1, 16])
def test_make_big_corpus_matches_the_golden_generator(raw_mb, tmp_path):
    want, got = tmp_path / "golden.txt", tmp_path / "port.txt"
    _golden_big_corpus().make_big_corpus(str(want), raw_mb)
    bench.make_big_corpus(str(got), raw_mb)
    assert got.stat().st_size == want.stat().st_size > raw_mb * 10**6
    assert bench._sha256(str(got)) == bench._sha256(str(want))


def test_ensure_big_corpus_reuses_only_the_known_bytes(tmp_path,
                                                       monkeypatch):
    """The config 2 corpus is written into the bench's directory, reused
    there only with its known size and digest (a one-block corpus stands
    in for the 1 GB one) and written anew otherwise; another file
    outside that directory is refused and left as it was."""
    monkeypatch.setattr(bench, "bench_dir", lambda: str(tmp_path / "own"))
    monkeypatch.setattr(bench, "BIG_RAW_MB", 1)
    path, reused = bench.ensure_big_corpus()
    assert path == bench.big_corpus_path() and not reused
    with open(path, "rb") as f:
        data = f.read()
    monkeypatch.setattr(bench, "BIG_CORPUS_BYTES", len(data))
    monkeypatch.setattr(bench, "BIG_CORPUS_SHA256", _sha(data))
    assert bench.ensure_big_corpus() == (path, True)
    with open(path, "wb") as f:
        f.write(data[:-1] + b"q")
    assert bench.ensure_big_corpus() == (path, False)
    with open(path, "rb") as f:
        assert f.read() == data
    mine = tmp_path / "mydata.txt"
    mine.write_bytes(b"my own data\n")
    with pytest.raises(bench.BenchError, match="not overwriting"):
        bench.ensure_big_corpus(str(mine))
    assert mine.read_bytes() == b"my own data\n"


def test_measure_big_vocab_reports_the_giant_route(tmp_path, monkeypatch):
    """measure_big_vocab on the CPU (the plain versions count no launch)
    at vocab 4608, on the first 400 KB of a one-block Heaps-law corpus:
    auto takes the giant engine at chunk width 1024 (few words), with the
    flat engine's merges."""
    path = str(tmp_path / "big.txt")
    bench.make_big_corpus(path, 1)
    with open(path, "rb") as f:
        data = f.read(400_000)
    with open(path, "wb") as f:
        f.write(data)
    monkeypatch.setattr(bench, "GIANT_VOCAB", 4608)
    monkeypatch.setattr(bench, "BIG_RUNS", 2)
    got = bench.measure_big_vocab(path, "cpu")
    assert got["engine"] == "giant" and got["chunk_width"] == 1024
    assert got["layout"]["cw"] == 1024 and got["layout"]["L"] == 16
    assert len(got["times"]) == 2 and got["seconds"] == min(got["times"])
    assert got["launches"] == {"K3": 0, "F1": 0} and got["peak_bytes"] == 0
    _, n = bench.train_once(path, "cpu", vocab=4608, engine="flat",
                            **bench.BIG)
    assert got["merges"] == n > 0


def test_constants_match_the_jax_bench():
    jb = _jax_bench()
    assert (bench.VOCAB, bench.MIN_FREQ, bench.COVERAGE, bench.RAW_MB) == \
        (jb.VOCAB, jb.MIN_FREQ, jb.COVERAGE, jb.RAW_MB)
    assert bench.default_corpus() != jb.CORPUS


def test_ensure_corpus_reuses_only_the_known_bytes(corpus_1mb, tmp_path,
                                                   monkeypatch):
    """The bench reuses a file only when it has the known corpus's size
    and digest (here the 1 MB corpus stands in for the 16 MB one); in
    its own directory a file of the same size with other bytes, or one
    over 95% of the size (which the JAX bench reuses), is written
    anew."""
    with open(corpus_1mb, "rb") as f:
        data = f.read()
    monkeypatch.setattr(bench, "bench_dir", lambda: str(tmp_path))
    monkeypatch.setattr(bench, "RAW_MB", 1)
    monkeypatch.setattr(bench, "CORPUS_BYTES", len(data))
    monkeypatch.setattr(bench, "CORPUS_SHA256", _sha(data))
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    assert bench.ensure_corpus(str(path), 1)
    other = bytearray(data)
    other[1000] = ord("q") if other[1000] != ord("q") else ord("r")
    for stale in (bytes(other), data[:int(len(data) * 0.96)]):
        path.write_bytes(stale)
        assert not bench.ensure_corpus(str(path), 1)
        assert path.read_bytes() == data


def test_ensure_corpus_never_overwrites_another_file(corpus_1mb, tmp_path,
                                                     monkeypatch):
    """Outside the bench's own directory an existing file that is not
    the known corpus is refused and left as it was, at any size; a
    missing path is written."""
    monkeypatch.setattr(bench, "bench_dir", lambda: str(tmp_path / "own"))
    mine = tmp_path / "mydata.txt"
    mine.write_bytes(b"my own data\n")
    for raw_mb in (bench.RAW_MB, 1):
        with pytest.raises(bench.BenchError, match="not overwriting"):
            bench.ensure_corpus(str(mine), raw_mb)
        assert mine.read_bytes() == b"my own data\n"
    fresh = tmp_path / "new" / "corpus.txt"
    assert not bench.ensure_corpus(str(fresh), 1)
    with open(corpus_1mb, "rb") as f:
        assert fresh.read_bytes() == f.read()


def test_main_prints_the_four_keys_of_bench_py(cpu_run):
    rc, out, _, _ = cpu_run
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert line["metric"] == "train_mb_s" and line["unit"] == "MB/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0


def test_main_reports_the_baseline_runs_and_cross_check(cpu_run):
    _, _, err, _ = cpu_run
    assert "[bench] baseline: native faithful engine" in err
    (runs,) = [ln for ln in err.splitlines() if "[bench] train vocab 768" in ln]
    times = runs.split("; runs ")[1].split(" s;")[0].split()
    assert len(times) == 1 and "median" in runs
    assert "cross-check: hist == giant == flat" in err


def test_measure_train_takes_the_best_of_3_after_a_warm_up(monkeypatch,
                                                          capsys):
    """bench.py's definition: one untimed warm-up, then 3 timed runs; the
    best counts, every time and the median are reported, and only the
    last run saves."""
    assert (bench.WARMUP, bench.RUNS) == (1, 3)
    times = iter([9.0, 0.5, 0.25, 0.75])
    calls = []

    def train_once(corpus, device, *, save_to=None, **cfg):
        calls.append(save_to)
        return next(times), 512

    monkeypatch.setattr(bench, "train_once", train_once)
    best, n, runs = bench.measure_train("unused", "cpu", save_to="out")
    assert (best, n, runs) == (0.25, 512, [0.5, 0.25, 0.75])
    assert calls == [None, None, None, "out"]
    err = capsys.readouterr().err
    assert "runs 0.500000 0.250000 0.750000 s; median 0.500000 s" in err


def test_measure_train_matches_the_jax_package(cpu_run, corpus_1mb):
    """The headline's saved bytes on the CPU == the JAX package's
    BPETrainer(backend="tpu") on the CPU, same corpus and config."""
    with open(GOLDEN_1MB) as f:
        golden = json.load(f)
    model, vocab = cpu_run[3]["headline"]
    with open(corpus_1mb, "rb") as f, open(cpu_run[3]["corpus"], "rb") as g:
        assert f.read() == g.read()
    assert golden["raw_bytes"] == os.path.getsize(corpus_1mb)
    assert cpu_run[3]["merges"] == golden["merges"]
    assert _sha(model) == golden["model_sha256"]
    assert _sha(vocab) == golden["vocab_sha256"]


def test_cross_check_passes_on_the_cpu(cpu_run):
    engines = cpu_run[3]["engines"]
    assert set(engines) == set(bench.ENGINES)
    assert all(out == cpu_run[3]["headline"] for out in engines.values())


def _fake_train(headline, bad_engine):
    """train_once that saves the real headline bytes, with one byte of
    bad_engine's model flipped."""
    def train_once(corpus, device, *, engine="auto", save_to=None, **cfg):
        model, vocab = headline
        if engine == bad_engine:
            model = model[:-1] + bytes([model[-1] ^ 1])
        if save_to is not None:
            with open(save_to + ".model", "wb") as f:
                f.write(model)
            with open(save_to + ".vocab", "wb") as f:
                f.write(vocab)
        return 1.0, len(model) // 12
    return train_once


@pytest.mark.parametrize("bad", bench.ENGINES)
def test_cross_check_raises_when_an_engine_differs(cpu_run, tmp_path,
                                                   monkeypatch, bad):
    monkeypatch.setattr(bench, "train_once",
                        _fake_train(cpu_run[3]["headline"], bad))
    with pytest.raises(bench.BenchError, match="cross-check FAILED"):
        bench.check_device_engines("unused", "cpu", str(tmp_path))


def test_main_prints_no_line_when_the_cross_check_fails(cpu_run, tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setattr(bench, "train_once",
                        _fake_train(cpu_run[3]["headline"], "giant"))
    with pytest.raises(bench.BenchError):
        bench.main(CPU_ARGV + ["--corpus", str(tmp_path / "corpus.txt")])
    assert "{" not in capsys.readouterr().out


def test_main_without_a_card_exits_with_config_error(tmp_path):
    """No --device cpu and no card: a non-zero exit through
    resolve_device's ConfigError, before any corpus is written, and no
    JSON line."""
    corpus = tmp_path / "corpus.txt"
    r = subprocess.run(
        [sys.executable, "-m", "shredword_tpu_torch.bench", "--raw-mb", "1",
         "--no-side", "--corpus", str(corpus)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "ConfigError" in r.stderr and "{" not in r.stdout
    assert not corpus.exists()


def test_presplit_side_metric_matches_the_jax_scanner(corpus_1mb):
    """The pre-split side metric's parity check holds on the CPU, and its
    chunks are the JAX package's native scanner's."""
    from shredword_tpu import pretokenize as jax_pretok

    got = bench.measure_presplit(corpus_1mb)
    with open(corpus_1mb, "rb") as f:
        data = f.read(8 * 10**6)
    assert got["chunks"] == len(jax_pretok.gpt_starts_bytes(data))
    assert got["native"] > 0 and got["regex"] > 0


def test_encode_kernel_metric_runs_the_plain_version_on_the_cpu(corpus_1mb):
    """On the CPU the kernel-only encode metric times encode_core's plain
    version over every whitespace chunk, whose ids are encode_array's;
    the launches' split is the card's alone."""
    from shredword_tpu_torch import Tokenizer
    from shredword_tpu_torch.ops import encode_ops

    tok = Tokenizer.train(corpus_1mb, vocab_size=300, min_pair_freq=50,
                          backend="cpu", device="cpu")
    with open(corpus_1mb) as f:
        text = f.read(100_000)
    got = bench.measure_encode_kernel(tok, text, torch.device("cpu"))
    flat = text.encode()
    assert got["chunks"] == len(encode_ops.ws_chunk_lens(
        np.frombuffer(flat, np.uint8)))
    assert got["kern_ms"] > 0 and got["kern_mbs"] > 0
    assert np.isnan(got["merge_ms"]) and np.isnan(got["pack_ms"])
