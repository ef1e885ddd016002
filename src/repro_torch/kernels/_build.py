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
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# source name -> seconds from the start of the last build() that compiled it
# to the end of its nvcc (all sources start together)
BUILD_SECONDS: dict = {}


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
    path.  Raises with nvcc's output when a build fails.  nvcc's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<library>.log``, and each source's seconds in
    ``BUILD_SECONDS``."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.is_file()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with tmp.with_name(tmp.name + ".log").open("w") as log:  # a file: a pipe could fill
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    pending = set(procs)
    while pending:
        for name in [n for n in pending if procs[n][1].poll() is not None]:
            BUILD_SECONDS[name] = time.perf_counter() - t0
            pending.discard(name)
        if pending:
            time.sleep(0.05)
    failed = []
    for name, (tmp, proc) in procs.items():
        log = tmp.with_name(tmp.name + ".log")
        lib = todo[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log.read_text()}")
            log.unlink()
            continue
        os.replace(log, lib.with_name(lib.name + ".log"))
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed (the
    kernel module that calls this keeps the handle)."""
    return ctypes.CDLL(str(build([name])[name]))


def build_variants(name: str, variants: dict, source: Path | None = None) -> dict:
    """Compile edited copies of ``csrc/<name>.cu`` (or of ``source``, such
    as an older version of it in another checkout) for an ablation, every
    ``nvcc`` started at once: ``variants`` maps a variant's name to a list of
    (old, new) textual edits (``[]`` for the source as it is).  The copies
    and their libraries go under ``.build/ablate/<name>/`` (the headers are
    found in ``csrc``); returns variant name -> library path.  Raises when
    an edit's text is missing or a build fails."""
    src = Path(source or CSRC / f"{name}.cu").read_text()
    out = BUILD_DIR / "ablate" / name
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for variant, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {variant!r}: {old!r} not found in {name}.cu")
            text = text.replace(old, new)
        stem = re.sub(r"[^A-Za-z0-9_-]", "_", variant)  # nvcc's file names take no commas
        cu, so = out / f"{stem}.cu", out / f"lib{stem}.so"
        cu.write_text(text)
        procs[variant] = (so, subprocess.Popen(
            [nvcc_path(), *flags, "-I", str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for variant, (so, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on variant {variant!r}:\n{stderr}{stdout}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {variant: so for variant, (so, _) in procs.items()}
