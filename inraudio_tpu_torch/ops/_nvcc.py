"""Build a CUDA source into a shared library with nvcc and load it with ctypes.

The library goes into ``inraudio_tpu_torch/csrc/build/<name>-<hash>/``, keyed
by a hash of the sources and flags, and is built at first use: nothing is
compiled when a module is imported.  A second process that finds the
library built reuses it; concurrent builders write to private temporary
names and rename atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = CSRC / "build"

# -fmad=false: no contraction of separate multiplies and adds, so every
# elementwise expression rounds op by op as the JAX reference does; the
# kernels write fmaf explicitly where they want a fused multiply-add.
# No --use_fast_math: sinf/cosf/tanhf and division stay IEEE-accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def library_path(name: str, sources: list[str]) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` (paths relative to ``csrc/``) unless already built
    and return the loaded library.  ``build.log`` beside it holds nvcc's
    output, including ptxas's register and shared-memory report."""
    lib = library_path(name, sources)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        (lib.parent / "build.log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
