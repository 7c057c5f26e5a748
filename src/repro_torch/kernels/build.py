"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``; nothing here
includes PyTorch's headers, so a build takes seconds.  Libraries go to the
repository's ``build/kernels/`` directory (listed in ``.gitignore``) and
are rebuilt whenever their source or a shared header is newer.  The
tensor-core kernel (``local_attn.cu``) encodes its TMA descriptors with
``cuTensorMapEncodeTiled``, reached through the runtime's driver entry
point, so nothing links against ``libcuda``.  No fast math: division and
FMA contraction stay IEEE, which the cascade gate's ``GATE_EPS`` slack
depends on.

Nothing is compiled at import; the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {name: CSRC / f"{name}.cu" for name in
           ("fused_band", "banded_sim", "jaccard_band", "local_attn")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    name: str
    path: Path
    seconds: float
    log: str          # nvcc's output, with -Xptxas -v's registers/smem


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME)")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildInfo]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib_path(name))       # atomic for concurrent users
        out[name] = BuildInfo(name, lib_path(name), secs, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def _stale(name: str) -> bool:
    """Whether the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    path = lib_path(name)
    if not path.exists():
        return True
    built = path.stat().st_mtime
    return any(built < src.stat().st_mtime
               for src in (SOURCES[name], *CSRC.glob("*.cuh")))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    if _stale(name):
        build([name])
    return ctypes.CDLL(str(lib_path(name)))
