"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``vista_slam_tpu_torch/_build/``, then loaded
with ``ctypes``. The library's file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return nvcc


class BuiltLibrary:
    """A loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when an existing build was reused
        self.log = log          # nvcc/ptxas output (registers, spills)


def _paths(source: str) -> tuple[Path, Path, Path]:
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{src.stem}_{digest.hexdigest()[:12]}"
    return src, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"


def build_many(sources) -> dict[str, float]:
    """Compile every missing ``csrc/<source>`` with one nvcc each, all
    started together; returns the seconds each compile took (0.0 for a
    build that already existed). Raises if any compile fails."""
    started = {}
    for source in sources:
        src, out, log_path = _paths(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
        proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[source] = (proc, tmp, time.perf_counter())
    seconds = dict.fromkeys(sources, 0.0)
    failed = []
    for source, (proc, tmp, t0) in started.items():
        output, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        src, out, log_path = _paths(source)
        log_path.write_text(output)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{output}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build(source: str) -> BuiltLibrary:
    """Compile ``csrc/<source>`` (if its build is missing) and load it."""
    seconds = build_many([source])[source]
    _, out, log_path = _paths(source)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
