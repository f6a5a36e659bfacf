"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface for ``sm_90a`` and loaded with ``ctypes``.  The
build happens at first use, from the sources in this package only, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  A library is named by a hash of its source, the headers
``csrc/*.cuh`` and the flags, so an edited source or header is rebuilt.
Nothing here runs at import: the CPU tests import every module and have no
``nvcc``.

:func:`build` and :func:`load` hold one module lock, so threads of one
process that reach a kernel first together build it once and load it once.
Processes that build into the same directory each compile into a temporary
named by process and thread and publish with ``os.replace``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> (source file, function that sets the ctypes signatures)
_KERNELS: dict[str, tuple[str, object]] = {}
# kernel name -> loaded library / nvcc's -Xptxas -v report
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}
# build() and load(): reentrant, since load() builds under it
_LOCK = threading.RLock()


def register(name: str, source: str, set_argtypes) -> None:
    _KERNELS[name] = (source, set_argtypes)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where the named kernel's library is (or will be) built."""
    h = hashlib.sha256((CSRC / _KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def cuda_tool(tool: str) -> str:
    """A program of the CUDA toolkit that holds nvcc (e.g. ``cuobjdump``)."""
    return str(Path(_nvcc()).with_name(tool))


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all registered ones by default) with one
    ``nvcc`` each, all started together.  Returns each kernel's ptxas
    report, kept beside its library for a later run that finds it built (a
    library found without its report is built again); raises if any build
    fails."""
    with _LOCK:
        return _build_locked(list(_KERNELS) if names is None else list(names))


def _build_locked(names: list) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if is_built(name):
            BUILD_LOGS.setdefault(name, log.read_text())
            continue
        tmp = out.with_suffix(
            f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / _KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
            logtmp = tmp.with_suffix(".logtmp")
            logtmp.write_text(log)
            os.replace(logtmp, out.with_suffix(".log"))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOGS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _KERNELS[name][1](lib)
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def is_built(name: str) -> bool:
    """Whether the named kernel's library and its ptxas report are on disk
    for the current sources (a :func:`load` would run no ``nvcc``)."""
    out = library_path(name)
    return out.exists() and out.with_suffix(".log").exists()


def cuda_error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"cudaError {err}: {lib.cuda_error_string(err).decode()}"
