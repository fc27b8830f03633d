"""The port stands alone: it imports neither JAX nor the JAX package nor
the JAX bench, at run time (a subprocess that blocks them trains every
engine, checkpoints, resumes and saves, encodes, decodes, saves and
loads a Tokenizer, trains, saves, loads and encodes Unigram, trains
the sharded giant and flat engines on one gloo rank, runs
``python -m shredword_tpu_torch`` train/encode/decode/info and the
device splitter on the CPU; another runs the port's bench on the CPU) and in its sources (an AST scan of the
package and of chip_smoke.py); its own copy of the native corpus loader
gives the JAX package's arrays; and its profiling hooks work on the
CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "shredword_tpu", "bench")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


# the prelude of each subprocess: an import of a blocked name raises
BLOCK = textwrap.dedent(f"""
    import sys

    BLOCKED = {BLOCKED!r}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".")
                   for b in BLOCKED):
                raise ImportError(name + " is blocked")

    sys.meta_path.insert(0, Block())
""")


def test_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    code = BLOCK + textwrap.dedent(f"""
        from shredword_tpu_torch import BPETrainer

        data = b"hello world, hello there, low lower lowest\\n" * 40
        out = {str(tmp_path)!r}
        saved = {{}}
        for kw in (dict(engine="hist"), dict(engine="giant"),
                   dict(engine="flat"), dict(backend="cpu")):
            t = BPETrainer(300, -1, 0.995, 2, device="cpu", **kw)
            t.load_corpus_bytes(data)
            assert t.train() > 0
            tag = "_".join(kw.values())
            t.save(f"{{out}}/{{tag}}.model", f"{{out}}/{{tag}}.vocab")
            saved[tag] = open(f"{{out}}/{{tag}}.model", "rb").read()
        assert saved["hist"] == saved["giant"] == saved["flat"]

        half = BPETrainer(300, -1, 0.995, 2, device="cpu")
        half.load_corpus_bytes(data)
        half.train(max_merges=5)
        half.save_checkpoint(f"{{out}}/half.ckpt")
        resumed = BPETrainer(300, -1, 0.995, 2, device="cpu")
        resumed.load_corpus_bytes(data)
        assert resumed.load_checkpoint(f"{{out}}/half.ckpt") == 5
        resumed.train()
        resumed.save(f"{{out}}/resumed.model", f"{{out}}/resumed.vocab")
        assert open(f"{{out}}/resumed.model", "rb").read() == saved["hist"]

        from shredword_tpu_torch import Tokenizer
        text = data.decode() + " x" * 70 + "y" * 80 + " it's 12 <|eot|>"
        for pattern in ("", "gpt"):
            tok = Tokenizer(resumed.merges, pattern=pattern, device="cpu",
                            special_tokens={{"<|eot|>": 1000}})
            ids = tok.encode(text, allowed_special="all")
            assert tok.decode(ids) == text and len(ids) < len(text)
            native = Tokenizer(resumed.merges, pattern=pattern,
                               backend="cpu")
            assert native.encode_ordinary(text) == tok.encode_ordinary(text)
            tok.save(f"{{out}}/tok{{pattern}}.model")
            back = Tokenizer.load(f"{{out}}/tok{{pattern}}.model",
                                  device="cpu")
            assert back.encode(text, allowed_special="all") == ids

        from shredword_tpu_torch import UnigramTokenizer, UnigramTrainer
        with open(f"{{out}}/uni.txt", "wb") as f:
            f.write(data)
        for backend in ("cuda", "cpu"):
            u = UnigramTrainer(target_vocab_size=40, seed_size=300,
                               max_word_len=16, backend=backend,
                               device="cpu")
            u.load_corpus(f"{{out}}/uni.txt")
            assert 0 < u.train() < 300
            u.save(f"{{out}}/uni_{{backend}}.model")
        utok = UnigramTokenizer.load(f"{{out}}/uni_cpu.model", device="cpu")
        uids = utok.encode("hello lower lowest")
        assert utok.decode(uids) == "hello lower lowest" and uids

        import torch.distributed as dist
        from shredword_tpu_torch.parallel import multihost
        multihost.initialize(f"file://{{out}}/store", world_size=1, rank=0,
                             backend="gloo")
        long = data + b"x" * 100 + b"\\n"
        for corpus, vocab in ((data, 5000), (long, 300)):
            got = []
            for kw in (dict(mesh=multihost.global_mesh("cpu")),
                       dict(engine="flat")):
                t = BPETrainer(vocab, -1, 0.995, 2, device="cpu", **kw)
                t.load_corpus_bytes(corpus)
                assert t.train() > 0
                t.save(f"{{out}}/s.model", f"{{out}}/s.vocab")
                got.append(open(f"{{out}}/s.vocab", "rb").read())
            assert got[0] == got[1]
        dist.destroy_process_group()

        import contextlib
        import io
        import runpy

        def cli(*argv):
            sys.argv = ["shredword_tpu_torch", *argv]
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    runpy.run_module("shredword_tpu_torch",
                                     run_name="__main__", alter_sys=True)
            except SystemExit as e:
                assert e.code == 0, (argv, e.code)

        with open(f"{{out}}/text.txt", "w") as f:
            f.write(text)
        cli("train", "--corpus", f"{{out}}/uni.txt", "--model",
            f"{{out}}/cli.model", "--vocab-size", "300", "--min-pair-freq",
            "2", "--device", "cpu")
        assert open(f"{{out}}/cli.model", "rb").read() == saved["hist"]
        cli("encode", "--model", f"{{out}}/cli.model", "--input",
            f"{{out}}/text.txt", "--output", f"{{out}}/ids.txt",
            "--device", "cpu")
        cli("decode", "--model", f"{{out}}/cli.model", "--input",
            f"{{out}}/ids.txt", "--output", f"{{out}}/back.txt")
        assert open(f"{{out}}/back.txt").read() == text
        cli("info", f"{{out}}/cli.model")

        import numpy as np
        from shredword_tpu_torch.ops import pretok_ops
        cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
        assert (pretok_ops.gpt_starts_device(cp, device="cpu")
                == pretok_ops.gpt_starts(cp)).all()

        loaded = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_bench_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """The port's bench imports nothing blocked, and its main runs on
    the CPU (baseline, headline, cross-check) and prints bench.py's
    four keys; its config 2 generator (make_big_corpus) runs too."""
    code = BLOCK + textwrap.dedent(f"""
        import contextlib
        import io
        import json

        import torch

        from shredword_tpu_torch import bench

        torch.set_num_threads(1)        # beside the other test workers
        # the smallest corpus make_corpus writes (one block of 20,000
        # words), one timed headline and no warm-up
        bench.WARMUP, bench.RUNS = 0, 1
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert bench.main(["--device", "cpu", "--raw-mb", "0.1",
                               "--no-side", "--corpus",
                               {str(tmp_path / "corpus.txt")!r}]) == 0
        line = json.loads(out.getvalue().splitlines()[-1])
        assert set(line) == {{"metric", "value", "unit", "vs_baseline"}}
        assert line["metric"] == "train_mb_s" and line["value"] > 0
        # the config 2 generator, at its smallest (one block)
        bench.make_big_corpus({str(tmp_path / "big.txt")!r}, 1)

        loaded = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print("ok")
    """)
    # about 20 s alone on one core
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def _sources():
    pkg = os.path.join(ROOT, "shredword_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "flat_compare.py")


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT) for p in _sources()))
def test_sources_import_no_jax(path):
    """No import statement anywhere in the file (module level or inside
    a function) names jax, shredword_tpu or bench."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _blocked(n)]


def test_native_loader_matches_jax_package(zipf_corpus_file):
    """The port's copy of the native runtime gives the JAX package's
    corpus arrays and coverage, in both word orders."""
    from shredword_tpu.runtime import native as jax_native
    from shredword_tpu_torch.runtime import native

    for faithful in (False, True):
        want = jax_native.NativeCorpus.from_file(zipf_corpus_file,
                                                 faithful_order=faithful)
        got = native.NativeCorpus.from_file(zipf_corpus_file,
                                            faithful_order=faithful)
        a, b = got.arrays(), want.arrays()
        for field in ("word_bytes", "offsets", "counts"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert (a.total_raw_bytes, a.total_occurrences) == \
            (b.total_raw_bytes, b.total_occurrences) and a.n_words > 100
        for cov in (0.995, 0.9999):
            ka, na, ua = got.coverage(cov)
            kb, nb, ub = want.coverage(cov)
            np.testing.assert_array_equal(ka, kb)
            assert (na, ua) == (nb, ub)
        got.free()
        want.free()
    from shredword_tpu.runtime import build as jax_build
    from shredword_tpu_torch.runtime import build

    assert os.path.basename(build.lib_path()).startswith("libshred_host-")
    assert build.lib_path() != jax_build.lib_path()


def test_profiling_trace_and_phase_report(tmp_path, monkeypatch):
    """trace() writes one Chrome trace under the directory given (or
    $SHREDWORD_TRACE) with the annotated region in it, nothing without
    one; phase_report() reads the Timers' totals."""
    import json

    import torch

    from shredword_tpu_torch.utils import logging as log
    from shredword_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "a")) as prof:
        with profiling.annotate("shred_region"):
            torch.ones(64).cumsum(0)
    assert prof is not None
    (path,) = (tmp_path / "a").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "shred_region" for e in events)
    monkeypatch.delenv("SHREDWORD_TRACE", raising=False)
    with profiling.trace() as prof:
        assert prof is None
    monkeypatch.setenv("SHREDWORD_TRACE", str(tmp_path / "env"))
    with profiling.trace():
        pass
    assert len(list((tmp_path / "env").iterdir())) == 1

    with log.Timer("torch_profiling_test", nbytes=2_000_000, log=False):
        pass
    rep = profiling.phase_report()["torch_profiling_test"]
    assert rep["bytes"] == 2_000_000 and rep["seconds"] >= 0
    assert set(rep) == {"seconds", "bytes", "mb_s"}


def test_cli_run_writes_a_trace(tmp_path, monkeypatch, capsys):
    """SHREDWORD_TRACE traces a whole CLI command."""
    from shredword_tpu_torch.cli import main

    model = tmp_path / "m.model"
    model.write_bytes(np.array([[104, 105, 256]], "<i4").tobytes())
    monkeypatch.setenv("SHREDWORD_TRACE", str(tmp_path / "t"))
    assert main(["info", str(model)]) == 0
    assert "merges:   1" in capsys.readouterr().out
    assert len(list((tmp_path / "t").iterdir())) == 1
