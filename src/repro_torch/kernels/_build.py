"""Builds the port's CUDA kernels at first use and loads them.

Every ``*.cu`` under ``repro_torch/kernels/<family>/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, under ``build/kernels/`` at the repository root (listed in
``.gitignore``), and loaded with ``ctypes``. All sources compile at once,
one ``nvcc`` process each. A library is named by a hash of its source and
flags, so an unchanged source is not rebuilt.

Plain ``nvcc`` + ``ctypes`` instead of ``torch.utils.cpp_extension.load``
is a design choice: the wrappers pass raw pointers and the stream through
a plain C entry point, so no source includes PyTorch's headers, no
binding file is needed, and a library does not depend on the installed
PyTorch's ABI.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: family -> nvcc output of the last build (``-Xptxas=-v``: registers,
#: shared memory and spills per kernel); empty when the library was reused
BUILD_LOGS: dict[str, str] = {}


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def build_all() -> dict[str, Path]:
    """Compile every kernel source whose library is missing, all in
    parallel. Returns family name -> library path; raises with nvcc's
    output if any source fails to compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    libs: dict[str, Path] = {}
    jobs = []
    for src in sources():
        key = hashlib.sha256(src.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib = BUILD_DIR / f"{src.stem}-{key[:16]}.so"
        libs[src.stem] = lib
        if lib.exists():
            BUILD_LOGS[src.stem] = ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, proc, tmp, lib))
    errors = []
    for name, proc, tmp, lib in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel family ``name``; builds every family
    on the first call in this process."""
    with _LOCK:
        if not _LIBS:
            for stem, path in build_all().items():
                _LIBS[stem] = ctypes.CDLL(str(path))
        return _LIBS[name]
