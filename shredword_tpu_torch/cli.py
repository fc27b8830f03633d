"""Command-line interface: ``python -m shredword_tpu_torch <cmd> ...``
(installed as ``shredword-tpu-torch``).

The JAX package's CLI (``shredword_tpu/cli.py``) with the same
subcommands, flags, defaults and printed lines, on PyTorch:

  train          corpus -> .model/.vocab (reference binary format)
  encode         text -> token ids using a trained model
  decode         token ids -> text
  convert        between the binary-triple and "shredword v1" formats
  info           summarize a model file
  train-unigram  corpus -> unigram LM model
  daemon         warm-process server (daemon.py)

``--backend`` is ``cuda`` (the device engines, default) or ``cpu`` (the
native engines) on train, encode and train-unigram, and ``--device``
(default ``cuda``) is the torch device of the ``cuda`` backend, passed
to ``BPETrainer``, ``Tokenizer.load`` and ``UnigramTrainer`` as their
own ``device`` argument: ``--device cpu`` runs the device engines'
plain versions on the CPU.  With the defaults and no card, train fails
with ``config.resolve_device``'s error.  decode, convert and info run on
the host and need no card.

With ``SHREDWORD_TORCH_DAEMON=1`` every command routes through the
port's daemon (auto-starting it); SHREDWORD_TRACE=<dir> writes a
torch.profiler trace of the command there (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import daemon
from .utils import profiling

BACKENDS = ("cuda", "cpu")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", choices=BACKENDS, default="cuda")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda backend (cpu runs the "
                        "device engines' plain versions)")


def _add_train(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("train", help="train a BPE model from a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True, help="output .model path")
    p.add_argument("--vocab", default=None, help="output .vocab path")
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("--unk-id", type=int, default=-1)
    p.add_argument("--coverage", type=float, default=0.995)
    p.add_argument("--min-pair-freq", type=int, default=2000)
    _add_device(p)
    p.add_argument("--engine", choices=("auto", "hist", "giant", "flat"),
                   default="auto",
                   help="device merge-loop engine (auto routes by vocab: "
                        "fused hist kernel <= 4096, giant table "
                        "<= 32768, flat beyond)")
    p.add_argument("--tie-break", choices=("lex", "faithful"),
                   default="lex")
    p.add_argument("--max-merges", type=int, default=None)
    p.add_argument("--shards", type=int, default=0,
                   help="data-parallel corpus shards over the default "
                        "torch.distributed group (0 = single device; "
                        "merge sequence stays bit-identical)")
    p.add_argument("--checkpoint-path", default=None,
                   help="write a resumable checkpoint here during training")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="merges between checkpoints")
    p.add_argument("--resume", default=None,
                   help="resume from this checkpoint file")


def _add_io(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", required=True, help="trained .model path")
    p.add_argument("--input", default="-",
                   help="input file ('-' = stdin)")
    p.add_argument("--output", default="-",
                   help="output file ('-' = stdout)")


def _read(path: str) -> str:
    if path == "-":
        return sys.stdin.read()
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _write(path: str, text: str) -> None:
    if path == "-":
        sys.stdout.write(text)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="shredword_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    _add_train(sub)

    pe = sub.add_parser("encode", help="encode text to token ids")
    _add_io(pe)
    _add_device(pe)

    pd = sub.add_parser("decode", help="decode token ids to text")
    _add_io(pd)

    pc = sub.add_parser("convert",
                        help="convert between model formats")
    pc.add_argument("src")
    pc.add_argument("dst")
    pc.add_argument("--pattern", default="")

    pi = sub.add_parser("info", help="summarize a model file")
    pi.add_argument("model")

    pu = sub.add_parser("train-unigram",
                        help="train a unigram LM tokenizer")
    pu.add_argument("--corpus", required=True)
    pu.add_argument("--model", required=True)
    pu.add_argument("--vocab-size", type=int, default=8192)
    pu.add_argument("--seed-size", type=int, default=100_000)
    pu.add_argument("--max-piece-len", type=int, default=15)
    pu.add_argument("--em-rounds", type=int, default=2)
    _add_device(pu)
    pu.add_argument("--shards", type=int, default=0,
                    help="data-parallel word shards over the default "
                         "torch.distributed group (0 = single device)")

    pda = sub.add_parser(
        "daemon", help="manage the warm-process command server")
    pda.add_argument("action",
                     choices=("start", "stop", "status", "serve"))
    pda.add_argument("--socket", default=None,
                     help=f"unix socket path (default: "
                          f"${daemon.SOCKET_ENV} or per-uid in the "
                          f"temporary directory)")
    pda.add_argument("--idle-timeout", type=float, default=3600.0,
                     help="seconds without a request before the server "
                          "exits (default 1h)")
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # Opt-in daemon routing: run the command in the warm server process
    # (auto-started).  The server itself calls main() with the in-daemon
    # variable set, so this cannot recurse; the daemon subcommand always
    # runs locally.
    if (os.environ.get(daemon.ROUTE_ENV) == "1"
            and not os.environ.get(daemon.IN_DAEMON_ENV)
            and argv[:1] != ["daemon"]):
        rc = daemon.run_client(argv)
        if rc is not None:
            return rc
        print("[warn] daemon unreachable; running locally",
              file=sys.stderr)

    args = parser().parse_args(argv)
    if args.cmd == "daemon":
        return _daemon(args)
    with profiling.trace():
        return _run(args)


def _daemon(args) -> int:
    if args.action == "serve":            # foreground server loop
        return daemon.serve(args.socket, idle_timeout=args.idle_timeout)
    if args.action == "start":
        ok = daemon.start(args.socket, idle_timeout=args.idle_timeout)
        print("daemon running" if ok else "daemon failed to start")
        return 0 if ok else 1
    if args.action == "stop":
        state = daemon.stop(args.socket)
        print({"stopped": "daemon stopped",
               "not running": "no daemon running",
               "busy": "daemon busy: it stops after its current "
                       "command"}[state])
        return 1 if state == "not running" else 0
    ok = daemon.alive(args.socket)
    print("daemon running" if ok else "no daemon running")
    return 0 if ok else 1


def _run(args) -> int:
    if args.cmd == "train":
        from .models.bpe import BPETrainer
        t = BPETrainer(target_vocab_size=args.vocab_size,
                       unk_id=args.unk_id,
                       character_coverage=args.coverage,
                       min_pair_freq=args.min_pair_freq,
                       backend=args.backend, engine=args.engine,
                       tie_break=args.tie_break,
                       checkpoint_path=args.checkpoint_path,
                       checkpoint_every=args.checkpoint_every,
                       shards=args.shards, device=args.device)
        t.load_corpus(args.corpus)
        if args.resume:
            n0 = t.load_checkpoint(args.resume)
            print(f"resuming after {n0} merges from {args.resume}")
        n = t.train(args.max_merges)
        vocab = args.vocab or (args.model.rsplit(".", 1)[0] + ".vocab")
        t.save(args.model, vocab)
        t.destroy()
        print(f"trained {n} merges -> {args.model}, {vocab}")
        return 0

    if args.cmd == "encode":
        from .tokenizer import Tokenizer
        tok = Tokenizer.load(args.model, backend=args.backend,
                             device=args.device)
        ids = tok.encode(_read(args.input), allowed_special="all")
        _write(args.output, " ".join(map(str, ids)) + "\n")
        return 0

    if args.cmd == "decode":
        from .tokenizer import Tokenizer
        # decoding is host work: the native backend resolves no device
        tok = Tokenizer.load(args.model, backend="cpu")
        ids = [int(x) for x in _read(args.input).split()]
        _write(args.output, tok.decode(ids))
        return 0

    if args.cmd == "convert":
        from . import serialization
        serialization.convert(args.src, args.dst, pattern=args.pattern)
        print(f"converted {args.src} -> {args.dst}")
        return 0

    if args.cmd == "info":
        from . import serialization
        merges, pattern, special = serialization.read_model_any(args.model)
        toks = serialization.token_strings(np.asarray(merges))
        longest = max(toks, key=len) if toks else b""
        print(f"model:    {args.model}")
        print(f"merges:   {len(merges)}")
        print(f"vocab:    {256 + len(merges)}")
        print(f"pattern:  {pattern!r}")
        print(f"specials: {len(special)}")
        print(f"longest token: {longest!r} ({len(longest)} bytes)")
        return 0

    if args.cmd == "train-unigram":
        from .models.unigram import UnigramTrainer
        t = UnigramTrainer(target_vocab_size=args.vocab_size,
                           seed_size=args.seed_size,
                           max_piece_len=args.max_piece_len,
                           num_em_rounds=args.em_rounds,
                           backend=args.backend, shards=args.shards,
                           device=args.device)
        t.load_corpus(args.corpus)
        n = t.train()
        t.save(args.model)
        print(f"trained unigram model with {n} pieces -> {args.model}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
