"""Build a CUDA source into a shared library with nvcc and load it with ctypes,
and count a kernel wrapper's calls.  Both are counters of
``utils.observability``: the seconds of the library ``<name>``'s nvcc run in
``nvcc.build_s.<name>`` and of its load in ``nvcc.load_s.<name>``, and a
wrapper's calls in ``launches.<wrapper>``.

The library goes into ``<root>/<name>-<hash>/``, keyed by a hash of the
sources and flags, and is built at first use: nothing is compiled when a
module is imported.  The root is ``inraudio_tpu_torch/csrc/build/`` where
the package directory is writable (a checkout), else a per-user cache,
``$XDG_CACHE_HOME/inraudio_tpu_torch`` or ``~/.cache/inraudio_tpu_torch``
(an installed package; the wheel ships ``csrc/*.cu`` and ``*.cuh``).  A
second process that finds the library built reuses it; concurrent builders
write to private temporary names and rename atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.observability import counter

CSRC = Path(__file__).resolve().parents[1] / "csrc"

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


def _writable(path: Path) -> bool:
    return os.access(path, os.W_OK)


def build_root() -> Path:
    """Where the libraries are built: ``csrc/build`` beside the sources
    when it exists writable or can be made there, else the per-user
    cache."""
    local = CSRC / "build"
    if _writable(local if local.is_dir() else CSRC):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "inraudio_tpu_torch"


def library_path(name: str, sources: list[str],
                 defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    # the shared headers are part of every source
    for src in [*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        h.update((CSRC / src).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return build_root() / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_library(name: str, sources: list[str],
                  defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``sources`` (paths relative to ``csrc/``) unless already built
    and return the loaded library; ``defines`` are extra ``-D`` flags.
    ``build.log`` beside it holds nvcc's output, including ptxas's register
    and shared-memory report."""
    lib = library_path(name, sources, defines)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               *[str(CSRC / s) for s in sources]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        counter(f"nvcc.build_s.{name}").add(time.perf_counter() - t0)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        (lib.parent / "build.log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    t0 = time.perf_counter()
    loaded = ctypes.CDLL(str(lib))
    counter(f"nvcc.load_s.{name}").add(time.perf_counter() - t0)
    return loaded


class LaunchCounter:
    """A kernel wrapper's launch count, the registry's counter
    ``launches.<name>``: ``launches`` rises by one per call of the wrapper
    (``count``), nowhere else, whatever kernels the call launches.  The
    increment holds the counter's lock, since ranks on threads of one
    process launch the same wrapper."""

    def __init__(self, name: str):
        self._counter = counter(f"launches.{name}")
        self._lock = self._counter.lock

    @property
    def launches(self) -> int:
        return self._counter.value

    @launches.setter
    def launches(self, value: int) -> None:
        with self._lock:
            self._counter.value = value

    def count(self) -> None:
        self._counter.add()
