"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface (no PyTorch headers, so
a build takes seconds).  Libraries go into ``repro_torch/.build/``, keyed by
a hash of the source, the headers beside it and the flags, so a changed
source is rebuilt and an unchanged one is reused.  Sources build in
parallel, one ``nvcc`` each.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels build only where the CUDA toolkit is installed")


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.name.encode() + b"\0" + part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (all of them by default) that have no
    library yet, every ``nvcc`` started at once; returns name -> library
    path.  Raises with nvcc's stderr when a build fails.  nvcc's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.is_file()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        lib = todo[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        lib.with_name(lib.name + ".log").write_text(stderr + stdout)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed (the
    kernel module that calls this keeps the handle)."""
    return ctypes.CDLL(str(build([name])[name]))
