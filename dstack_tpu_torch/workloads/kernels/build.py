"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles into ``<repo>/build/torch_kernels/
<name>-<hash>.so``, a shared library with a plain C interface loaded through
``ctypes``; the hash covers the source, every header in ``csrc/`` (the
sources include them) and the compiler flags, so an edited source or header
builds anew and an unchanged one loads the library already built. The
compiler's output of each build (``-Xptxas -v``: registers, spills and
shared memory per kernel) stays in ``build_logs``.
Builds happen at first use (or all at once, in parallel, through
``build_all``), never at import. A missing ``nvcc`` or a failed build raises:
there is no fallback to the plain PyTorch versions on a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source built by this process.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels are built"
        " from source at first use and need the CUDA toolkit"
    )


def nvcc_argv(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the file name carries a hash of
    the source, of every ``csrc/*.cuh`` header and of the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Sequence[str] = ()) -> List[Path]:
    """Compile every named source (default: all of ``csrc/``) that has no
    library yet, one ``nvcc`` per source, all started together. Raises with
    the compiler's output when any build fails."""
    names = list(names) or sources()
    pending = [(n, library_path(n)) for n in names]
    pending = [(n, out) for n, out in pending if not out.exists()]
    if pending:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in pending:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            argv = nvcc_argv(nvcc, CSRC_DIR / f"{name}.cu", tmp)
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, out, tmp, argv, proc))
        failures = []
        for name, out, tmp, argv, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{' '.join(argv)}\n{log}")
            else:
                build_logs[name] = log
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
