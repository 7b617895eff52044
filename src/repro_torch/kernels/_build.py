"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, includes the shared
helpers of ``csrc/common.cuh``, and is compiled on first use, for
``sm_90a``, into ``build/repro_torch_kernels/`` at the root of the
checkout (``build/`` is git-ignored).  The library's file name carries a
hash of its source, the headers and the flags, so an edited source is
rebuilt and an unchanged one is reused.  A failed build raises: there
is no fallback.  Nothing is built at import time.

Every wrapper launches through ``launch``: each entry point is bound
(library loaded, ``argtypes`` and ``restype`` set) on its first call, and
later calls go straight to the bound function on the tensor's current
stream, so a call's host cost is the wrapper's checks, its allocations and
the ctypes call itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.RLock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# (source stem, symbol) -> the entry point with its argtypes and restype set
_BOUND: Dict[Tuple[str, str], Callable[..., int]] = {}


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
    """Where the library built from ``csrc/<name>.cu`` lives; its hash
    covers the shared headers (``csrc/*.cuh``) too."""
    text = sources()[name].read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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


def sass_counts(name: str, opcode: str = "HMMA") -> Dict[str, int]:
    """Instructions ``opcode`` in each kernel function of the library
    built from ``csrc/<name>.cu`` (mangled name -> count), read from
    ``cuobjdump -sass``; builds the library if needed.  ``HMMA`` is the
    tensor cores' matrix multiply-add."""
    path = build([name])[name]
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name("cuobjdump"))
    out = subprocess.run(
        [tool, "-sass", str(path)], capture_output=True, text=True, check=True
    ).stdout
    counts: Dict[str, int] = {}
    fn = None
    pattern = re.compile(rf"\b{re.escape(opcode)}\b")
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            fn = line[len("Function : "):]
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def _bind(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """Load ``csrc/<name>.cu``'s library and set the argument and result
    types of its entry point ``symbol``, once; later calls find the bound
    function in ``_BOUND`` without the lock."""
    with _LOCK:
        fn = _BOUND.get((name, symbol))
        if fn is None:
            fn = getattr(load(name), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _BOUND[(name, symbol)] = fn
        return fn


def call(name: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<name>.cu``, bound to
    ``argtypes`` on its first call.

    Every entry point returns ``cudaGetLastError()`` right after its
    launch, so a launch the device refuses raises ``RuntimeError`` here.
    """
    fn = _BOUND.get((name, symbol))
    if fn is None:
        fn = _bind(name, symbol, argtypes)
    err = fn(*args)
    if err != 0:
        text = _bind(name, "repro_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{symbol} launch failed: cuda error {err}: {text(err).decode()}")


def launch(name: str, symbol: str, argtypes: Sequence, on: torch.Tensor, *args) -> None:
    """``call`` the entry point ``symbol`` with ``args`` and, last, the raw
    current stream of the CUDA device that holds ``on``; the device is made
    current for the call only when it is not already.  ``argtypes`` names
    the stream too (``ctypes.c_void_p``, last).  Every kernel wrapper
    launches through here."""
    index = on.get_device()
    if index == torch._C._cuda_getDevice():
        call(name, symbol, argtypes, *args, torch._C._cuda_getCurrentRawStream(index))
        return
    with torch.cuda.device(index):
        call(name, symbol, argtypes, *args, torch._C._cuda_getCurrentRawStream(index))
