"""Seeded inputs of the GPT splitter tests, shared by the CPU tests
against the JAX package (test_torch_pretok.py) and the card's tests of
csrc/pretok.cu (test_torch_cuda.py, chip_smoke.py).  Imports no JAX."""

import numpy as np

# tests/test_pretok_dfa.py's CASES, copied
CASES = [
    "hello world", "we'll they've it's can't o'clock", "'ll 'Ve 'S",
    " 'll", "\t'll", "''ll", "!'s", "x'lx", "'l", "'sx", "1234567",
    "a1234b", "abc!!def", "!word", "!!word", " !", " !\n\nx", "x\ny",
    "x  \ny", "hi  there", "hi ", "x  ", " \n", " \n \n  a", "a   b",
    "...", "a...b", "héllo wörld", "日本語のテキスト", "ſtop'ſ",
    "tab\there", "mixed 123abc !@# \r\n done", "\r", "\n\n\n",
    "a\r\nb", "!?\r\nx", "  leading", "trailing  ", "'", "''", "' ",
    "don't stop believing", "1'll", "½¾⅓ nums ٣٤٥", "Ａｂｃ", "ǅungla",
    "price: $5.99!", "'re're", " ", "x", "🙂 emoji !", "под вопросом",
]

# tests/test_pretok_dfa.py's fuzz alphabet
ALPHABET = list("abcsSDMTLVRE 'AB12890!?.\t\r\n\x0b") + [
    chr(c) for c in (0x85, 0xA0, 0x2028, 0x3000, 0x17F, 0x660, 0x4E00,
                     0x1F600, 0xBC)]

# long texts: lengths around the powers of two, runs over 1024 (the
# first version's tile)
LONG_NS = (1023, 1024, 1025, 4097)
LONG_SEEDS = (0, 1, 2)
_RUNS = (" ", "\t", "\n", "7", "\r\n", " \n", "'")
_SHORT = ("a", "!", "'s", " x", "!\n", "hi ", "12", "\n\n", "  ", "'ll",
          " 123", "ſ", "\t!")


def fuzz(seed: int = 17, count: int = 120) -> list[str]:
    """`count` seeded strings of 1..119 characters over ALPHABET."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET)
                    for _ in range(int(rng.integers(1, 120))))
            for _ in range(count)]


def long_text(n: int, seed: int) -> str:
    """n characters of short pieces and runs of 1025-1499 spaces, tabs,
    newlines, digits or apostrophes (one starts the text)."""
    rng = np.random.default_rng(seed + 1000 * n)
    parts, size = [], 0
    while size < n:
        if not parts or rng.random() < 0.3:
            run = _RUNS[int(rng.integers(len(_RUNS)))]
            parts.append(run * (int(rng.integers(1025, 1500)) // len(run)))
        else:
            parts.append("".join(rng.choice(_SHORT)
                                 for _ in range(int(rng.integers(1, 6)))))
        size += len(parts[-1])
    return "".join(parts)[:n]


# one run of 1100 spaces, newlines (after a punct: absorbed), tabs and
# digits each
RUNS_TEXT = ("x" + " " * 1100 + "!" + "\n" * 1100 + "y" + "\t" * 1100 + "'"
             + "7" * 1100 + " end")


# csrc/pretok.cu's tile: 1024 threads of 16 positions
TILE = 16384
# lengths around one and two tiles
TILE_NS = (16383, 16384, 16385, 32769)
TILE_SEEDS = (0, 1)
# runs of each class (space, other whitespace, CR LF, newline, mixed
# whitespace, digit, letter, apostrophe, punctuation) across the edges
EDGE_RUNS = (" ", "\t", "\r\n", "\n", " \n", "7", "a", "'", "!")


def edge_run_text(run: str) -> str:
    """2 * TILE + 1 characters: seeded short pieces, with a run of `run`
    from 300 characters before the first tile edge to 300 after it and
    another across the second edge, the last character of the text."""
    rng = np.random.default_rng(len(run) * 131 + ord(run[0]))

    def pieces(n: int) -> str:
        out = ""
        while len(out) < n:
            out += "".join(rng.choice(_SHORT) for _ in range(3)) + " "
        return out[:n]

    def runs(n: int) -> str:
        return (run * (n // len(run) + 1))[:n]

    text = pieces(TILE - 300) + runs(600) + pieces(TILE - 800)
    return text + runs(2 * TILE + 1 - len(text))


# runs longer than a tile, after a newline: a tile inside the run takes
# its carries from tiles two away in both directions
LONG_RUNS = (" ", "\t", "\n", " \n", "7")


def long_run_text(run: str) -> str:
    """A run of `run` from position 3 over 2 * TILE + 100 characters
    (across two tile edges, a whole tile inside it), after "ab\n"."""
    n = 2 * TILE + 100
    return "ab\n" + (run * (n // len(run) + 1))[:n] + "cd 12 x"


def long_texts() -> list[str]:
    return ([long_text(n, s) for n in LONG_NS for s in LONG_SEEDS]
            + [RUNS_TEXT, RUNS_TEXT[:4097]]
            + [long_text(n, s) for n in TILE_NS for s in TILE_SEEDS]
            + [edge_run_text(r) for r in EDGE_RUNS]
            + [long_run_text(r) for r in LONG_RUNS])


def all_inputs() -> list[str]:
    return CASES + fuzz() + long_texts()


def code_points(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), np.uint32)
