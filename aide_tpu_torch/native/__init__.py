"""The port's native host library: largest connected component and volume
confusion counts in C++, bound with ctypes.

An own copy of ``aide_tpu.native``. Case evaluation keeps the largest
connected component of every predicted case volume on every epoch
(``ops/cc.py``), on the host; ``csrc/hostops.cpp`` does it with one
union-find pass over the voxels. The library is built from that source with
g++ at first use into ``build/host/`` beside the package (a directory
.gitignore lists), once per digest of the source, the flags and the host,
and loaded with ctypes. Where it cannot be built or loaded it raises: there
is no fallback (``ops/cc.keep_largest_connected_components_plain`` is the
same function in numpy, for the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

import numpy as np

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "hostops.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "host")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)


def build() -> str:
    """Compile ``SOURCE`` with ``CXX``, once per digest of the source, the
    compiler and flags, and the host, and return the shared library's
    path. Several processes may build at once: each writes its own
    temporary file and renames it into place."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    host = f"{platform.machine()}|{platform.processor()}|{platform.node()}"
    tag = " ".join((CXX,) + CXX_FLAGS) + "|" + host
    key = hashlib.sha1(src + tag.encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libhostops_{key}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the native host library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"{CXX} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The library, built and loaded on first use, with its functions
    typed; raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.keep_largest_cc.restype = ctypes.c_int32
            lib.keep_largest_cc.argtypes = [_u8p] + [ctypes.c_int32] * 3 + [_u8p]
            lib.volume_confusion.restype = None
            lib.volume_confusion.argtypes = (
                [_u8p, _u8p, ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int64)] * 4)
            _lib = lib
        return _lib


def _binary(mask: np.ndarray) -> np.ndarray:
    """Contiguous uint8 0/1 of ``mask > 0``."""
    return np.ascontiguousarray(np.asarray(mask) > 0, dtype=np.uint8)


def keep_largest_cc(mask: np.ndarray) -> np.ndarray:
    """(H, W) or (S, H, W) mask -> uint8 mask of its largest face-connected
    foreground component (``mask > 0``; all zeros when there is none)."""
    m = _binary(mask)
    if m.ndim not in (2, 3):
        raise ValueError(f"keep_largest_cc takes an (H, W) or (S, H, W) mask, got {m.shape}")
    if m.size >= 1 << 31:
        raise ValueError(f"keep_largest_cc indexes voxels in 32 bits, got {m.size}")
    d, h, w = m.shape if m.ndim == 3 else (1, *m.shape)
    out = np.empty_like(m)
    load().keep_largest_cc(m.ctypes.data_as(_u8p), d, h, w, out.ctypes.data_as(_u8p))
    return out


def volume_confusion(pred: np.ndarray, target: np.ndarray) -> tuple:
    """(tp, tn, fp, fn) voxel counts of two binary volumes of one shape
    (``> 0`` is foreground)."""
    p, t = _binary(pred), _binary(target)
    if p.shape != t.shape:
        raise ValueError(f"pred/target shape mismatch: {p.shape} vs {t.shape}")
    outs = [ctypes.c_int64() for _ in range(4)]
    load().volume_confusion(p.ctypes.data_as(_u8p), t.ctypes.data_as(_u8p), p.size,
                            *[ctypes.byref(o) for o in outs])
    return tuple(o.value for o in outs)
