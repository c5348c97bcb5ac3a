"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
through ctypes.

Each kernel is one ``.cu`` file with a plain C entry point (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes).  It is compiled for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``build/kernels/`` at the root of the checkout, a directory that
``.gitignore`` lists; the library's file name carries a hash of the
source and flags, so an edited source is rebuilt.  Nothing is compiled
when a module is imported: :meth:`CudaKernel.library` builds on the
first launch, and :func:`build_all` builds several kernels at once,
one ``nvcc`` process per source, all started together.

Every pointer and the stream go to the C function as
``ctypes.c_void_p``.  The C function returns ``cudaGetLastError()``
after its launch; :meth:`CudaKernel.launch` raises if that is not 0, so
a refused launch (too much shared memory, too many threads) is never
silent, and it is the only place a kernel's launch counter moves.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


class CudaKernel:
    """One hand-written CUDA kernel: its source, its C entry point, the
    library built from it, and its launch counter (``launches``)."""

    def __init__(self, name: str, source: Path, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    # -- build ----------------------------------------------------------------
    def _lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _nvcc_cmd(self, out: Path) -> List[str]:
        return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
                str(self.source)]

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this kernel (None if already built)."""
        lib = self._lib_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(self._nvcc_cmd(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp          # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp_path, self._lib_path())  # type: ignore

    def library(self):
        """The loaded C entry point, building the library first if
        needed."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self._lib_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    # -- launch ---------------------------------------------------------------
    def launch(self, *args) -> None:
        """Call the C entry point; raise on a non-zero CUDA error code.
        Counts one launch."""
        rc = self.library()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, str]:
    """Build every kernel that is not built yet, one ``nvcc`` per source,
    all started together; then load them.  Returns each kernel's
    ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills)."""
    procs = [(k, k.start_build()) for k in kernels]
    try:
        for k, p in procs:
            k.finish_build(p)
    finally:      # a failed build leaves no other nvcc running
        for _, p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    for k in kernels:
        k.library()
    return {k.name: k.build_log for k in kernels}


def dtype_name(dt) -> str:
    """The gate's name of a torch dtype: "bf16", "f32", else its own."""
    name = str(dt).replace("torch.", "")
    return {"bfloat16": "bf16", "float32": "f32"}.get(name, name)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
