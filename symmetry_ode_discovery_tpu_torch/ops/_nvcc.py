"""Building the port's native code: nvcc (the CUDA kernels) or g++ (the GP
engine's host breeding core) by hand into a shared library with a plain C
interface, loaded with ctypes.

Each source under csrc/ is compiled once per hash of its text, compiler and
flags into build/torch_kernels/lib{stem}_{hash}.so, at first use, never at
import; the compiler's output (nvcc's -Xptxas -v report) is kept beside it as
lib{stem}_{hash}.log, so a library loaded from an earlier build reports the
same. ``build_all`` starts one compiler per source that needs it, all at
once, and waits for them together. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Kernel:
    """One source, its compiler flags and its ctypes signatures.

    ``signatures`` maps each exported C function to (argtypes, restype).
    ``compiler`` is "nvcc" (CUDA sources) or "g++" (host code). ``lib``
    loads (building first when needed); ``info`` records the library path,
    whether this process compiled it, the seconds taken and the compiler's
    output (nvcc's -Xptxas -v report), read back from the build's log when
    the library was built earlier."""

    def __init__(self, source: Path, flags, signatures: dict, compiler: str = "nvcc"):
        self.source = Path(source)
        self.flags = tuple(flags)
        self.signatures = signatures
        self.compiler = compiler
        self.info: dict = {}
        self._lib = None
        self._proc = None
        self._t0 = 0.0

    @property
    def so_path(self) -> Path:
        text = self.source.read_bytes() + " ".join((self.compiler,) + self.flags).encode()
        digest = hashlib.sha256(text).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    @property
    def log_path(self) -> Path:
        return self.so_path.with_suffix(".log")

    def start(self) -> None:
        """Start the compiler for this source unless its library and log exist
        already."""
        if self._lib is not None or self._proc is not None:
            return
        self._t0 = time.perf_counter()
        so = self.so_path
        if so.exists() and self.log_path.exists():
            return
        if self.compiler == "nvcc":
            cc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        else:
            cc = shutil.which(self.compiler)
            if cc is None:
                raise RuntimeError(f"{self.compiler} not found: {self.source.name} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
        self._proc = subprocess.Popen(
            [cc, *self.flags, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def lib(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        self.start()
        so, log_path = self.so_path, self.log_path
        compiled = self._proc is not None
        if compiled:
            _, log = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            if rc != 0:
                raise RuntimeError(f"{self.compiler} failed on {self.source.name} ({rc}):\n{log}")
            # the log lands first: a library on disk always has its report
            tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
            tmp_log.write_text(log)
            os.replace(tmp_log, log_path)
            os.replace(self._tmp, so)
        else:
            log = log_path.read_text()
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        self.info.update(path=str(so), compiled=compiled, ptxas=log,
                         seconds=time.perf_counter() - self._t0)
        self._lib = lib
        return lib


def build_all(kernels) -> None:
    """Build several kernels with their nvcc processes running in parallel."""
    for k in kernels:
        k.start()
    for k in kernels:
        k.lib()
