"""Global configuration: precision, device, dtypes and random streams.

PyTorch counterpart of ``sionna_tpu/phy/config.py``. Precision
"single"/"double" maps to ``torch.float32``/``complex64`` and
``torch.float64``/``complex128``. Every block passes explicit dtypes, so
nothing here changes a process-wide default.

Device: ``config.device`` (default ``"cuda"``, the current card) is
where a block that is given no ``device`` puts its tables and draws, as
the JAX package runs on its accelerator by default. On a machine without
a card that default does not turn into the CPU: the first tensor made
there raises torch's own error. Set ``config.device = "cpu"`` (or pass
``device="cpu"``) to run on the CPU.

Random state: ``config.seed`` seeds Python's ``random``, NumPy and one
default ``torch.Generator`` per device (created on first use). Random
blocks take ``generator=`` where the JAX package takes ``key=``; without
one they draw from ``config.generator(device)``.
"""

import random

import numpy as np
import torch

#: Map of precision name to the associated torch/NumPy dtypes
dtypes = {
    "single": {
        "torch": {"rdtype": torch.float32, "cdtype": torch.complex64},
        "np": {"rdtype": np.float32, "cdtype": np.complex64},
    },
    "double": {
        "torch": {"rdtype": torch.float64, "cdtype": torch.complex128},
        "np": {"rdtype": np.float64, "cdtype": np.complex128},
    },
}


class Config:
    """Singleton holding global state: seed, precision, RNG streams."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._initialized = False
        return cls._instance

    def __init__(self):
        if self._initialized:
            return
        self._initialized = True
        self._seed = None
        self._py_rng = None
        self._np_rng = None
        self._generators = {}
        self._precision = "single"
        self._device = torch.device("cuda")

    @property
    def py_rng(self):
        """`random.Random` : Python RNG stream"""
        if self._py_rng is None:
            self._py_rng = random.Random(self._seed)
        return self._py_rng

    @property
    def np_rng(self):
        """`np.random.Generator` : NumPy RNG stream"""
        if self._np_rng is None:
            self._np_rng = np.random.default_rng(self._seed)
        return self._np_rng

    def generator(self, device=None):
        """Default ``torch.Generator`` of ``device`` (default:
        :attr:`device`), seeded from ``seed`` (or from the OS when no
        seed is set)."""
        device = self._device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._generators:
            g = torch.Generator(device=device)
            if self._seed is None:
                g.seed()
            else:
                g.manual_seed(self._seed)
            self._generators[device] = g
        return self._generators[device]

    @property
    def seed(self):
        """int | None : Global seed; setting it reseeds all RNG streams"""
        return self._seed

    @seed.setter
    def seed(self, seed):
        if seed is not None:
            seed = int(seed)
        self._seed = seed
        self._py_rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._generators = {}

    @property
    def device(self):
        """torch.device : Where blocks built without ``device`` live
        (default ``cuda``); takes anything ``torch.device`` takes"""
        return self._device

    @device.setter
    def device(self, v):
        self._device = torch.device(v)

    @property
    def precision(self):
        """"single" | "double" : Global numerical precision"""
        return self._precision

    @precision.setter
    def precision(self, v):
        if v not in ("single", "double"):
            raise ValueError("precision must be 'single' or 'double'")
        self._precision = v

    @property
    def np_rdtype(self):
        """np.dtype : NumPy real dtype for the global precision"""
        return dtypes[self.precision]["np"]["rdtype"]

    @property
    def np_cdtype(self):
        """np.dtype : NumPy complex dtype for the global precision"""
        return dtypes[self.precision]["np"]["cdtype"]

    @property
    def rdtype(self):
        """torch.dtype : Real dtype for the global precision"""
        return dtypes[self.precision]["torch"]["rdtype"]

    @property
    def cdtype(self):
        """torch.dtype : Complex dtype for the global precision"""
        return dtypes[self.precision]["torch"]["cdtype"]


#: The global configuration singleton
config = Config()
