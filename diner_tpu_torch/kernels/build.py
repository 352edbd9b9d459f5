"""Build and load the CUDA kernels of `diner_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C launch function and is compiled on
its own by nvcc into `build/diner_tpu_torch/lib<name>-<hash>.so` at the repo
root, then loaded with ctypes. The file name carries a hash of the source, so
an edited kernel is rebuilt and a built one is reused. Nothing is built at
import time: a kernel is built at its first launch, or all of them in
parallel by `build_all()`. A host library, `csrc/<name>.cpp`, is built the
same way by the C++ compiler (`host_library`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diner_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]
# dynamic shared memory one block may use on Hopper (227 KB); a launch above
# 48 KB opts in with cudaFuncSetAttribute
MAX_SHARED_BYTES = 232_448


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "diner_tpu_torch are built with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path), or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) found: the host "
                       "library csrc/*.cpp of diner_tpu_torch is built with it")


def host_library(name: str) -> Path:
    """Build `csrc/<name>.cpp`, a host library, with the C++ compiler into
    `build/diner_tpu_torch/lib<name>-<hash>.so` unless it is built, and
    return its path."""
    src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed for csrc/{name}.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def kernel_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Sequence[str] = ()) -> None:
    """Build every kernel (or `names`), one nvcc per source, all started
    together, and wait for all of them."""
    names = list(names) or kernel_sources()
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, s in started.items():
        try:
            _finish_build(n, s)
        except RuntimeError as e:  # report every failed source, not the first
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


class CudaKernel:
    """One launch function of a csrc/ library, with its count of launches.

    `launch(*args)` calls the C function, which launches the kernel on the
    given stream and returns cudaGetLastError(); a nonzero code raises.
    `launches` counts successful launches and nothing else, under a lock:
    several host threads (one a card) may launch at once.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _load(self):
        with self._lock:
            if self._fn is None:
                build_all([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{err}")
        with self._lock:
            self.launches += 1
