"""Builds the port's hand-written CUDA kernels and binds them with ctypes.

Each kernel is a ``.cu`` file under ``sionna_tpu_torch/csrc/`` with a
plain C interface (shared device code in ``csrc/*.cuh``). On first use,
``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/sionna_tpu_torch/`` at the repository root; the library's file
name carries a hash of the source, the headers and the flags, so it is
rebuilt only when one of them changes. A kernel may take constants from
the Python side as ``-D`` defines, so that they have one source. Nothing
is downloaded, and a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "sionna_tpu_torch"
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
        """Compiles the source (unless a library of the same source and
        flags exists) and returns the library's path."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(self.flags).encode())
        path = BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"
        log = path.with_suffix(".log")
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.source.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        self.build_log = log.read_text() if log.exists() else ""
        return path

    def library(self):
        """The loaded library, built on first use."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fname, (argtypes, restype) in self._functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib

    def check(self, err):
        """Raises if a C entry point returned a CUDA error code."""
        if err != 0:
            msg = self.library().sionna_cuda_error_string(err)
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {err} "
                f"({msg.decode() if msg else 'unknown'})")
