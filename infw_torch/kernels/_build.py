"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/infw_torch/`` at the repository root (a git-ignored directory).
The library name carries a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged source
loads the cached library.  No PyTorch headers are included, so a build
takes seconds.

Nothing here runs at import: the CPU test host has no ``nvcc``, and the
tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = CSRC.parents[2] / "build" / "infw_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


class Kernel:
    """One hand-written CUDA kernel: its source (``csrc/<source>.cu``,
    ``source`` defaulting to ``name``; another tree's ``csrc`` builds that
    tree's version), its shared library (one per source, so two entry
    points of one source share it), its C entry point, and ``launches``,
    the number of times a wrapper launched it (incremented in ``launch``
    and nowhere else)."""

    def __init__(self, name: str, symbol: str, argtypes: List, csrc: Path = CSRC,
                 source: Optional[str] = None) -> None:
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.csrc = Path(csrc)
        self.source = self.csrc / f"{source or name}.cu"
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.csrc.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build_log(self) -> str:
        """nvcc's output for the current library (ptxas register, shared
        memory and spill lines), empty before the first build."""
        log = self.library_path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def build(self) -> None:
        """Run nvcc for this source unless its library exists; install the
        library (an atomic rename, so a concurrent loader never sees a
        partial file) and its log.  Raises if nvcc fails."""
        lib = self.library_path()
        if lib.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {proc.returncode}):\n{proc.stdout}"
            )
        lib.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, lib)

    def _entry(self):
        with self._lock:
            if self._fn is None:
                self.build()
                fn = getattr(ctypes.CDLL(str(self.library_path())), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def query(self, *args) -> int:
        """Call a C entry point that launches nothing (a device query or
        set-up) and return its result; counts nothing."""
        return (self._fn or self._entry())(*args)

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns cudaGetLastError()); raise if it reports an error."""
        rc = (self._fn or self._entry())(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {rc}")
        self.launches += 1

