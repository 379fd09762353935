"""Builds the port's hand-written CUDA kernels and host libraries and
binds them with ctypes.

Each kernel is a ``.cu`` file under ``sionna_tpu_torch/csrc/`` with a
plain C interface (shared device code in ``csrc/*.cuh``). On first use,
``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/sionna_tpu_torch/`` at the repository root; the library's file
name carries a hash of the source, the headers and the flags, so it is
rebuilt only when one of them changes. A kernel may take constants from
the Python side as ``-D`` defines, so that they have one source. Nothing
is downloaded, and a failed build raises.

A host library (``HostLibrary``: a ``.cpp`` file under ``csrc/``, such
as the ray tracer's cluster builder) is built the same way with ``g++
-O3 -shared -fPIC``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "sionna_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home \
        else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_so(name, source, flags, compiler, extra=b""):
    """Compiles ``source`` with ``[compiler, *flags, -o, out, source]``
    into ``BUILD_DIR`` (unless a library of the same source, ``extra``
    bytes and flags exists) and returns ``(path, log, seconds)``:
    the compiler's output and the seconds its build took (0 when it was
    built before). Raises when the compiler fails."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(extra)
    digest.update(" ".join(flags).encode())
    path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, "-o", str(tmp),
                               str(source)], capture_output=True,
                              text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed for {source.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
        seconds = time.perf_counter() - t0
    return path, (log.read_text() if log.exists() else ""), seconds


def _bind(path, functions):
    """Loads the library at ``path`` and sets the argtypes and restype of
    each C entry point in ``functions`` (name -> ``(argtypes,
    restype)``)."""
    lib = ctypes.CDLL(str(path))
    for fname, (argtypes, restype) in functions.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


class CudaKernel:
    """One hand-written CUDA kernel: where its source is, which TPU
    kernel it replaces, its C entry points, and a count of launches.

    ``functions`` maps each exported C function to ``(argtypes,
    restype)``; ``defines`` maps macro names to the values nvcc gets for
    them. The wrapper that launches the kernel calls
    :meth:`count` once per launch, and nowhere else: it adds one to the
    launch's variant in ``variant_launches``.
    """

    def __init__(self, name, source, replaces, functions, defines=None):
        self.name = name
        self.source = CSRC_DIR / source
        self.replaces = replaces
        self._functions = functions
        self.flags = NVCC_FLAGS + [f"-D{k}={v}"
                                   for k, v in (defines or {}).items()]
        self._lib = None
        self.variant_launches = {}
        self.build_log = None

    @property
    def launches(self):
        """Launches of every variant since the last :meth:`reset`."""
        return sum(self.variant_launches.values())

    def count(self, variant):
        """Counts one launch of ``variant`` (e.g. "f32", "bf16")."""
        self.variant_launches[variant] = \
            self.variant_launches.get(variant, 0) + 1

    def reset(self):
        """Sets every launch count to 0."""
        self.variant_launches = {}

    def build(self):
        """Compiles the source (unless a library of the same source,
        headers and flags exists) and returns the library's path."""
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC_DIR.glob("*.cuh")))
        path, self.build_log, _ = _build_so(self.name, self.source,
                                            self.flags, _nvcc(), headers)
        return path

    def library(self):
        """The loaded library, built on first use."""
        if self._lib is None:
            self._lib = _bind(self.build(), self._functions)
        return self._lib

    def check(self, err):
        """Raises if a C entry point returned a CUDA error code."""
        if err != 0:
            msg = self.library().sionna_cuda_error_string(err)
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {err} "
                f"({msg.decode() if msg else 'unknown'})")


class HostLibrary:
    """One C++ library for the host: its source, its C entry points
    (``functions`` maps each to ``(argtypes, restype)``) and the seconds
    its build took in this process (0 when it was built before)."""

    def __init__(self, name, source, functions):
        self.name = name
        self.source = CSRC_DIR / source
        self._functions = functions
        self._lib = None
        self.build_seconds = 0.0

    def build(self):
        """Compiles the source with ``g++`` (unless a library of the same
        source and flags exists) and returns the library's path; raises
        when the compile fails."""
        path, _, seconds = _build_so(self.name, self.source, GXX_FLAGS,
                                     "g++")
        self.build_seconds = self.build_seconds or seconds
        return path

    def library(self):
        """The loaded library, built on first use."""
        if self._lib is None:
            self._lib = _bind(self.build(), self._functions)
        return self._lib
