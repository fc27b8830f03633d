"""Build driver for the port's native host runtime (libshred_host.so).

The C++ sources under ``runtime/csrc`` (the corpus loader with threaded
dedup, the faithful CPU trainer and the merge-replay encoder) are the
JAX package's, copied as they are.  They build with g++ at first use
into ``shredword_tpu_torch/build/`` (beside the CUDA kernel library),
named by a content hash of the sources and flags, so an edit triggers a
rebuild and the library never collides with the JAX package's
``libshred_native-*.so`` in a process that loads both.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_THIS_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_THIS_DIR), "build")
SOURCES = ["corpus.cpp", "faithful.cpp", "encode.cpp", "unigram.cpp",
           "pretok.cpp", "dedup.cpp", "api.cpp"]
HEADERS = ["shred_native.hpp"]

CXX = os.environ.get("SHRED_CXX", "g++")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
            "-march=native", "-Wall"]


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join([CXX] + CXXFLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libshred_host-{_source_hash()}.so")


def build(verbose: bool = False) -> str:
    """Build (if needed) and return the path to the shared library."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    # build to a temp file then rename: atomic under concurrent builders
    # (test workers may build at once)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXXFLAGS, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed:\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verbose:
        print(f"[shredword_tpu_torch] built native runtime: {out}")
    return out


if __name__ == "__main__":
    print(build(verbose=True))
