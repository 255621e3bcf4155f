"""Building the hand-written CUDA kernels in ``csrc/`` and loading them.

Each ``csrc/*.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library at first use, from the sources in
this checkout, into ``build/kernels/`` beside the package, and loaded
with ``ctypes``. The library's name carries a hash of the source and the
flags, so an edited source is rebuilt. A build failure raises; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
# -fmad=false keeps each multiply and add rounded separately, as the plain
# PyTorch versions compute them, so the kernels' results are bit-identical.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def nvcc_path() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin",
                                          "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str) -> pathlib.Path:
    """Compile ``csrc/<source>`` (or ``source``, where it is an absolute
    path) unless its library exists; returns its path. nvcc's messages
    (ptxas register and shared-memory use) are kept beside it as
    ``.log``."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source} (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    return out


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
