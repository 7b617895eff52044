"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, for ``sm_90a``, into ``build/repro_torch_kernels/`` at the
root of the checkout (``build/`` is git-ignored).  The library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  A failed build raises: there
is no fallback.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> Dict[str, Path]:
    """Every CUDA source of the package, by stem."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise KernelBuildError(
            f"nvcc not found (looked on PATH and in {home}/bin); the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = sources()[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: all), one ``nvcc`` each, in parallel.

    Returns name -> library path.  Up-to-date libraries are reused.  The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (
            tmp,
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        Path(f"{out[name]}.log").write_text(log)
        os.replace(tmp, out[name])
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
