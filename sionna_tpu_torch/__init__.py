"""Sionna-TPU ported to PyTorch and CUDA for NVIDIA Hopper (H100).

Beside the JAX package ``sionna_tpu``, which stays the reference, this
package mirrors its module tree and public names. It imports torch,
NumPy and SciPy, and never JAX or ``sionna_tpu``. Hand-written CUDA
kernels live in ``csrc/`` and are built with nvcc on first use (see
``_build.py``).
"""

__version__ = "0.1.0"

from . import phy, rt, sys
