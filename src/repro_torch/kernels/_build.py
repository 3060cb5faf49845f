"""Build CUDA C++ source text into a shared library and launch its kernels.

New in the port (the JAX package hands Pallas source to XLA instead).  A
source string is compiled by ``nvcc`` for ``sm_90a`` into a ``.so`` with a
plain C interface and loaded with ``ctypes``; no PyTorch header is
included, so one build takes seconds.  Builds are cached on disk by
``sha256(source + flags)`` under ``build/kernels/`` at the repository root
(listed in ``.gitignore``) and in memory per process.  Concurrent builds of
one source (pool workers in one process) are serialised by a per-key lock;
each build writes to a temporary file and then ``os.replace``s it, so a
reader never sees half a library.

Every exported C function returns the ``cudaError_t`` of its launch;
:func:`check` turns a non-zero code into :class:`LaunchRefusedError` (the
launch never ran: too much shared memory or too many threads — the Hopper
form of a TPU VMEM refusal) or :class:`CudaError` (anything else).
:data:`LAUNCHES` counts each wrapper's successful launches.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"

# cudaErrorInvalidValue (a dynamic shared-memory request above the opt-in
# limit), cudaErrorInvalidConfiguration, cudaErrorLaunchOutOfResources
REFUSED_CODES = frozenset({1, 9, 701})

#: wrapper name -> number of kernel launches that wrapper made
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
_locks: collections.defaultdict = collections.defaultdict(threading.Lock)
_locks_guard = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the source."""


class LaunchRefusedError(RuntimeError):
    """The card refused the launch before it ran (resources)."""


class CudaError(RuntimeError):
    """A CUDA call of a kernel wrapper failed."""


@functools.lru_cache(maxsize=None)
def read_csrc(name: str) -> str:
    return (CSRC_DIR / name).read_text()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build CUDA kernels")


def _key(source: str, flags: tuple) -> str:
    return hashlib.sha256((source + "\0" + " ".join(flags)).encode()).hexdigest()


def _compile(source: str, flags: tuple, lib_path: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src = pathlib.Path(tmp) / "kernel.cu"
        out = pathlib.Path(tmp) / "kernel.so"
        src.write_text(source)
        proc = subprocess.run([nvcc_path(), *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(out, lib_path)


def compile_source(source: str) -> ctypes.CDLL:
    """Compile (or fetch from the cache) and load ``source``."""
    key = _key(source, NVCC_FLAGS)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks[key]
    with lock:
        lib = _libs.get(key)
        if lib is None:
            lib_path = BUILD_DIR / f"{key[:32]}.so"
            if not lib_path.exists():
                _compile(source, NVCC_FLAGS, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            lib.sg_error_string.restype = ctypes.c_char_p
            lib.sg_error_string.argtypes = [ctypes.c_int]
            _libs[key] = lib
    return lib


def build_many(sources) -> list:
    """Build several sources at once, one nvcc process each."""
    sources = list(sources)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(sources))) as ex:
        futs = [ex.submit(compile_source, s) for s in sources]
        return [f.result() for f in futs]


def bind(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """The C function ``name(ptr * n_ptr, int * n_int, stream)``.  Every
    pointer and the stream travel as ``c_void_p``: ctypes would otherwise
    pass a 32-bit int and cut the address."""
    fn = getattr(lib, name)   # ctypes caches it: set the types once
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
    return fn


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc == 0:
        return
    msg = f"{what}: {lib.sg_error_string(rc).decode()} (cudaError {rc})"
    if rc in REFUSED_CODES:
        raise LaunchRefusedError(msg)
    raise CudaError(msg)


def launch(counter: str, lib: ctypes.CDLL, fn_name: str, ptrs, ints,
           device) -> None:
    """Call one exported launcher on the current stream, raise on a
    non-zero return, and count the launch under ``counter``."""
    fn = bind(lib, fn_name, len(ptrs), len(ints))
    rc = fn(*ptrs, *ints, stream_ptr(device))
    check(lib, rc, f"{counter} launch")
    LAUNCHES[counter] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
