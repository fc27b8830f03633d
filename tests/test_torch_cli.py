"""The port's CLI (python -m shredword_tpu_torch) against the JAX
package's (tests/test_cli.py mirrored on the port, with --device cpu:
the device engines' plain versions): .model/.vocab bytes, ids, decode
round trips, convert/info lines and Unigram pieces equal the JAX CLI's;
decode, convert and info resolve no CUDA device; with the defaults and
no card, train fails with resolve_device's error."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from shredword_tpu import cli as jax_cli
from shredword_tpu_torch import BPETrainer, Tokenizer, UnigramTrainer
from shredword_tpu_torch import serialization, tokenizer
from shredword_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--vocab-size", "320", "--unk-id", "-1", "--min-pair-freq", "2"]
TEXT = "the quick brown fox jumps over the lazy dog\nwe'll 123 ſtop!\n"


def _run(fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _files(prefix) -> tuple[bytes, bytes]:
    with open(prefix + ".model", "rb") as f, open(prefix + ".vocab",
                                                  "rb") as g:
        return f.read(), g.read()


def _train(fn, corpus, prefix, *flags) -> tuple[bytes, bytes]:
    rc, out = _run(fn, ["train", "--corpus", corpus, "--model",
                        prefix + ".model", "--vocab", prefix + ".vocab",
                        *TRAIN, *flags])
    assert rc == 0
    assert out.startswith("trained ") and out.endswith(
        f"-> {prefix}.model, {prefix}.vocab\n")
    return _files(prefix)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, request):
    """The port CLI's hist engine on the CPU device, and the JAX CLI's
    flat engine (XLA on the CPU), on the small corpus at vocab 320."""
    corpus = request.getfixturevalue("small_corpus_file")
    d = tmp_path_factory.mktemp("torch_cli")
    port = _train(main, corpus, str(d / "port"), "--engine", "hist",
                  "--device", "cpu")
    jax_out = _train(jax_cli.main, corpus, str(d / "jax"), "--engine",
                     "flat", "--backend", "tpu")
    return corpus, str(d / "port.model"), port, jax_out


def test_train_matches_jax_cli(trained):
    _, _, port, jax_out = trained
    assert port == jax_out


@pytest.mark.parametrize("engine", ["giant", "flat", "auto"])
def test_train_engines_match(trained, engine, tmp_path):
    corpus, _, port, _ = trained
    assert _train(main, corpus, str(tmp_path / engine), "--engine", engine,
                  "--device", "cpu") == port


def test_faithful_tie_break_matches_library_and_jax(trained, tmp_path):
    corpus = trained[0]
    got = _train(main, corpus, str(tmp_path / "f"), "--tie-break",
                 "faithful", "--backend", "cpu")
    t = BPETrainer(target_vocab_size=320, unk_id=-1, min_pair_freq=2,
                   backend="cpu", tie_break="faithful")
    t.load_corpus(corpus)
    t.train()
    t.save(str(tmp_path / "lib.model"), str(tmp_path / "lib.vocab"))
    t.destroy()
    assert got == _files(str(tmp_path / "lib"))
    assert got == _train(jax_cli.main, corpus, str(tmp_path / "j"),
                         "--tie-break", "faithful", "--backend", "cpu")


def test_train_checkpoint_and_resume(trained, tmp_path):
    corpus, _, port, _ = trained
    ckpt = str(tmp_path / "c.ckpt")
    _train(main, corpus, str(tmp_path / "half"), "--device", "cpu",
           "--max-merges", "20", "--checkpoint-path", ckpt,
           "--checkpoint-every", "10")
    rc, out = _run(main, ["train", "--corpus", corpus, "--model",
                          str(tmp_path / "r.model"), *TRAIN, "--device",
                          "cpu", "--resume", ckpt])
    assert rc == 0 and out.startswith(f"resuming after 20 merges from {ckpt}")
    assert _files(str(tmp_path / "r")) == port


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_encode_matches_jax_cli_and_decode_round_trips(trained, backend,
                                                       tmp_path):
    _, model, _, _ = trained
    text_in = str(tmp_path / "in.txt")
    with open(text_in, "w") as f:
        f.write(TEXT)
    ids_port, ids_jax = str(tmp_path / "p.ids"), str(tmp_path / "j.ids")
    rc, _ = _run(main, ["encode", "--model", model, "--input", text_in,
                        "--output", ids_port, "--backend", backend,
                        "--device", "cpu"])
    assert rc == 0
    assert _run(jax_cli.main, ["encode", "--model", model, "--input",
                               text_in, "--output", ids_jax])[0] == 0
    ids = open(ids_port).read()
    assert ids == open(ids_jax).read()
    assert [int(x) for x in ids.split()] == Tokenizer.load(
        model, device="cpu").encode(TEXT)
    out = str(tmp_path / "out.txt")
    assert _run(main, ["decode", "--model", model, "--input", ids_port,
                       "--output", out])[0] == 0
    assert open(out).read() == TEXT


def test_stdin_and_stdout(trained, monkeypatch):
    _, model, _, _ = trained
    monkeypatch.setattr(sys, "stdin", io.StringIO(TEXT))
    rc, ids = _run(main, ["encode", "--model", model, "--device", "cpu"])
    assert rc == 0
    monkeypatch.setattr(sys, "stdin", io.StringIO(ids))
    assert _run(main, ["decode", "--model", model]) == (0, TEXT)


def test_convert_and_info_print_the_jax_lines(trained, tmp_path):
    _, model, _, _ = trained
    outs = {}
    for tag, fn in (("port", main), ("jax", jax_cli.main)):
        v1 = str(tmp_path / f"{tag}.v1.model")
        rc, out = _run(fn, ["convert", model, v1, "--pattern", "gpt"])
        assert rc == 0 and out == f"converted {model} -> {v1}\n"
        rc, info = _run(fn, ["info", v1])
        assert rc == 0
        outs[tag] = (open(v1, "rb").read(), info.replace(v1, "M"))
    assert outs["port"] == outs["jax"]
    m_bin = serialization.read_model_any(model)[0]
    assert f"merges:   {len(m_bin)}\n" in outs["port"][1]
    assert "pattern:  'gpt'" in outs["port"][1]


def test_host_commands_resolve_no_device(trained, tmp_path, monkeypatch):
    """decode, convert and info are host work: they run with every CUDA
    device lookup refused."""
    _, model, _, _ = trained

    def refuse(*a, **k):
        raise AssertionError("a CUDA device was resolved")

    monkeypatch.setattr(tokenizer, "resolve_device", refuse)
    ids = str(tmp_path / "ids")
    with open(ids, "w") as f:
        f.write("104 101 108 108 111")
    assert _run(main, ["decode", "--model", model, "--input", ids]) \
        == (0, "hello")
    assert _run(main, ["convert", model, str(tmp_path / "v1")])[0] == 0
    assert _run(main, ["info", model])[0] == 0


def test_train_unigram_matches_jax_cli(trained, tmp_path, monkeypatch):
    corpus = trained[0]
    flags = ["--corpus", corpus, "--vocab-size", "120", "--seed-size",
             "1500"]
    port, jax_model = str(tmp_path / "p.model"), str(tmp_path / "j.model")
    rc, out = _run(main, ["train-unigram", *flags, "--model", port,
                          "--device", "cpu"])
    assert rc == 0
    assert out == f"trained unigram model with 120 pieces -> {port}\n"
    monkeypatch.setenv("SHRED_INTERPRET_OK", "1")
    assert _run(jax_cli.main, ["train-unigram", *flags, "--model",
                               jax_model])[0] == 0
    pieces = UnigramTrainer.load_model(port)[0]
    assert len(pieces) == 120
    assert pieces == UnigramTrainer.load_model(jax_model)[0]


def test_backends_and_prog():
    with pytest.raises(SystemExit):
        main(["train", "--corpus", "c", "--model", "m", "--backend", "tpu"])
    from shredword_tpu_torch.cli import parser
    ap = parser()
    assert ap.prog == "shredword_tpu_torch"
    for cmd in (["train", "--corpus", "c", "--model", "m"],
                ["encode", "--model", "m"],
                ["train-unigram", "--corpus", "c", "--model", "m"]):
        args = ap.parse_args(cmd)
        assert (args.backend, args.device) == ("cuda", "cuda")


def test_default_train_needs_the_card(trained, tmp_path):
    """python -m shredword_tpu_torch train with the defaults: on a host
    with no card it fails with resolve_device's error (no CPU fallback);
    with one it trains."""
    corpus = trained[0]
    r = subprocess.run(
        [sys.executable, "-m", "shredword_tpu_torch", "train", "--corpus",
         corpus, "--model", str(tmp_path / "d.model"), *TRAIN],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        assert r.returncode == 0, r.stderr
        return
    assert r.returncode != 0
    assert "ConfigError" in r.stderr and "needs a CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "d.model")


def test_module_entry_point(trained, tmp_path):
    _, model, _, _ = trained
    r = subprocess.run([sys.executable, "-m", "shredword_tpu_torch", "info",
                        model], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    want = _run(jax_cli.main, ["info", model])[1]
    assert r.stdout == want
    assert np.asarray(serialization.read_model_any(model)[0]).shape[1] == 2
