"""The port stands alone: it imports neither JAX nor the JAX package nor
the JAX bench, at run time (a subprocess that blocks them trains every
engine, checkpoints, resumes and saves, encodes, decodes, saves and
loads a Tokenizer, trains, saves, loads and encodes Unigram, and trains
the sharded giant and flat engines on one gloo rank) and in
its sources (an AST scan of the package and of
chip_smoke.py); and its own copy of the native corpus loader gives the
JAX package's arrays."""

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


def test_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import sys

        BLOCKED = {BLOCKED!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".")
                       for b in BLOCKED):
                    raise ImportError(name + " is blocked")

        sys.meta_path.insert(0, Block())
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

        loaded = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not loaded, loaded
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _sources():
    pkg = os.path.join(ROOT, "shredword_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


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
