"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions that take device
pointers, sizes and a stream, launch one kernel and return
``cudaGetLastError()``. The source is compiled on first use into
``build/torch_kernels/<name>-<hash>.so`` at the repository root; the hash
covers the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. nvcc's report (``-Xptxas=-v``: registers,
shared memory and spills of each kernel) is kept beside the library as
``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class Kernel:
    """One ``csrc/<name>.cu`` file, built into a shared library on first use.

    ``functions`` maps each exported C function to its ctypes argument
    types (all return ``int``, a ``cudaError_t``). ``launches`` counts the
    successful calls made through :meth:`launch`, and only those;
    ``fn_launches`` counts them per exported function (a source that
    exports two kernels' launchers, such as K3's mono and stereo variants).
    """

    def __init__(self, name: str, functions: dict[str, list]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = functions
        self.launches = 0
        self.fn_launches = {fn: 0 for fn in functions}
        self.build_seconds: float | None = None
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def build(self) -> ctypes.CDLL:
        """Compile (if needed) and load the library; raises on failure."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            t0 = time.perf_counter()
            path = self.library_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                       str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.source.name} "
                        f"(exit {proc.returncode}):\n{proc.stderr}")
                path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self.build_seconds = time.perf_counter() - t0
            self._lib = lib
            return lib

    def launch(self, fn: str, *args) -> None:
        """Launch through an exported function and count the launch;
        raises if the launch was refused."""
        lib = self.build()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {err} "
                               f"({msg})")
        self.launches += 1
        self.fn_launches[fn] += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, t, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
