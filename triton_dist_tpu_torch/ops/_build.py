"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``<name>-<hash>.so`` in ``triton_dist_tpu_torch/_kernels/``
(git-ignored), where the hash covers the source, the headers of
``csrc/`` and the command, so an edited source never loads a stale
build. Nothing is built at import:
the first CUDA call of a kernel's wrapper builds it (or
:func:`build_all` builds every source at once, one ``nvcc`` each, all
started together). The build needs ``nvcc`` for ``sm_90a`` (Hopper).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels"
#: Every CUDA source of the port, by library name.
SOURCES = {"gemm_ar": CSRC_DIR / "gemm_ar.cu",
           "flash_decode": CSRC_DIR / "flash_decode.cu",
           "ag_gemm": CSRC_DIR / "ag_gemm.cu",
           "group_gemm": CSRC_DIR / "group_gemm.cu",
           "moe_rs": CSRC_DIR / "moe_rs.cu",
           "allgather": CSRC_DIR / "allgather.cu",
           "sp_attention": CSRC_DIR / "sp_attention.cu",
           "all_to_all": CSRC_DIR / "all_to_all.cu",
           "ag_gemm_ring": CSRC_DIR / "ag_gemm_ring.cu",
           "gemm_rs_ring": CSRC_DIR / "gemm_rs_ring.cu",
           "ag_group_gemm": CSRC_DIR / "ag_group_gemm.cu",
           "moe_rs_ring": CSRC_DIR / "moe_rs_ring.cu",
           "reduce_world": CSRC_DIR / "reduce_world.cu",
           "p2p": CSRC_DIR / "p2p.cu"}
#: The headers the sources include (``csrc/*.cuh``).
HEADERS = sorted(CSRC_DIR.glob("*.cuh"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from PyTorch's idea of CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on this machine")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list:
    """The compile command of one source: a shared library for sm_90a."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(output), str(source)]


def _library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(nvcc_command(source, Path("out"))).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile the named sources (default: all) that have no current
    build, one ``nvcc`` process each, all running at once. Returns
    ``{name: path}``. Raises ``RuntimeError`` with the compiler's output
    when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                nvcc_command(SOURCES[n], tmp, nvcc),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exited {proc.returncode}\n"
                              f"{out.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib

