"""The port's CUDA C++ kernels built with nvcc into shared libraries (a
plain C interface, loaded with ctypes), once per hash of the source and
the flags, under ``build/kernels`` beside the package (a directory
.gitignore lists)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
NVCC = "/usr/local/cuda/bin/nvcc"


def build(source: str, stem: str, flags: Sequence[str], verbose: bool = False) -> str:
    """Compile ``source`` with nvcc and ``flags`` into ``lib<stem>_<hash>.so``
    unless that library is there, and return its path. Raises where nvcc
    is missing or fails."""
    with open(source, "rb") as fh:
        src = fh.read()
    key = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{key}.so")
    if os.path.exists(out):
        return out
    nvcc = shutil.which("nvcc") or NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: the CUDA kernels of {stem} cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *flags]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out
