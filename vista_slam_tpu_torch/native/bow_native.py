"""ctypes binding for the C++ BoW kernels (native/src/bow.cpp).

A copy of vista_slam_tpu/native/bow_native.py. Compiles the shared library
on first use with g++ into the git-ignored ``vista_slam_tpu_torch/_build/``
(never next to the source; the file name carries a hash of the source) and
exposes `descend_native(vocab, descriptors)` and
`l1_score_native(a, b)`; nothing is built at import. native/bow.py uses
these where the helper builds and its numpy path elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "bow.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
with open(_SRC, "rb") as _f:
    _LIB = os.path.join(_BUILD_DIR, "libvistabow_"
                        f"{hashlib.sha256(_f.read()).hexdigest()[:12]}.so")


def _build() -> str:
    if os.path.exists(_LIB):
        return _LIB
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a unique temp name + atomic rename: two processes building
    # in a fresh checkout concurrently must never dlopen a half-written .so
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


_lib = None


def load() -> ctypes.CDLL:
    """The helper library, built (if missing) and loaded at first call.
    Raises OSError where g++ is missing and CalledProcessError where it
    fails."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        lib.vb_descend.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.vb_l1_score.restype = ctypes.c_float
        lib.vb_l1_score.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def descend_native(vocab, descriptors: np.ndarray) -> np.ndarray:
    ci = np.ascontiguousarray(vocab.child_idx, np.int32)
    cd = np.ascontiguousarray(vocab.child_desc, np.uint8)
    nw = np.ascontiguousarray(vocab.node_word, np.int32)
    d = np.ascontiguousarray(descriptors, np.uint8)
    out = np.empty(len(d), np.int32)
    load().vb_descend(
        _ptr(ci, ctypes.c_int32), _ptr(cd, ctypes.c_uint8),
        _ptr(nw, ctypes.c_int32), ctypes.c_int32(len(nw)),
        ctypes.c_int32(vocab.k), ctypes.c_int32(vocab.levels),
        _ptr(d, ctypes.c_uint8), ctypes.c_int32(len(d)),
        _ptr(out, ctypes.c_int32))
    return out


def l1_score_native(a, b) -> float:
    return float(load().vb_l1_score(
        _ptr(np.ascontiguousarray(a.ids, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(a.vals, np.float32), ctypes.c_float),
        ctypes.c_int32(len(a.ids)),
        _ptr(np.ascontiguousarray(b.ids, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(b.vals, np.float32), ctypes.c_float),
        ctypes.c_int32(len(b.ids))))
