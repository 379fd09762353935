"""NR config base class (counterpart of ``sionna_tpu/phy/nr/config.py``;
plain Python, a copy of the JAX package's)."""

import copy
from abc import ABC

import numpy as np


class Config(ABC):
    """Declarative kwargs-driven configuration base for the 5G NR
    sub-package."""

    def __init__(self, **kwargs):
        for key, value in kwargs.items():
            if key in dir(self):
                setattr(self, key, value)

    def _ifndef(self, name, value):
        if not hasattr(self, f"_{name}"):
            setattr(self, f"_{name}", value)

    def clone(self, deep=True):
        """Returns a copy of the Config object."""
        return copy.deepcopy(self) if deep else copy.copy(self)

    def check_config(self):
        pass

    def show(self):
        """Prints all properties of the configuration."""
        self.check_config()
        print(self._name)
        print("=" * len(self._name))
        for a in dir(self):
            if a[0] == "_" or a in ("show", "name", "check_config",
                                    "check_config_precoded", "clone",
                                    "c_init", "dmrs", "tb", "carrier"):
                continue
            val = getattr(self, a)
            if a in ("dmrs_grid", "dmrs_grid_precoded", "dmrs_mask",
                     "n"):
                print(f"{a} : shape {np.array(val).shape}")
            else:
                print(f"{a} : {val}")
        print("\r")

    @property
    def name(self):
        return self._name
