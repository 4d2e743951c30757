"""Builds the runtime's C++ sources with g++ into the package's ignored
`_build/` directory, one shared library per source content.

The library's name carries a hash of its source, so an edited source is
rebuilt; it is compiled under a temporary name and moved into place with
`os.replace`, so processes that build the same library at once (test
workers, the ranks of one run) never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_library(src: str, stem: str, extra_flags=()) -> str:
    """Path of lib<stem>-<hash>.so built from `src`, compiled if absent."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, *extra_flags, src, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
