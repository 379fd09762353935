"""5G NR carrier configuration (counterpart of
``sionna_tpu/phy/nr/carrier_config.py``; TS 38.211 numerology). Plain
Python, a copy of the JAX package's."""

from .config import Config

__all__ = ["CarrierConfig"]

_SCS_LIST = [15, 30, 60, 120, 240, 480, 960]


class CarrierConfig(Config):
    """Carrier numerology and slot/frame structure (TS 38.211)."""

    def __init__(self, **kwargs):
        self._name = "Carrier Configuration"
        super().__init__(**kwargs)
        self.check_config()

    @property
    def n_cell_id(self):
        """Physical layer cell identity [0..1007] (default 1)."""
        self._ifndef("n_cell_id", 1)
        return self._n_cell_id

    @n_cell_id.setter
    def n_cell_id(self, value):
        if value not in range(1008):
            raise ValueError(
                "n_cell_id must be in the range from 0 to 1007")
        self._n_cell_id = value

    @property
    def cyclic_prefix(self):
        """"normal" (14 symbols/slot) | "extended" (12; 60 kHz only)."""
        self._ifndef("cyclic_prefix", "normal")
        return self._cyclic_prefix

    @cyclic_prefix.setter
    def cyclic_prefix(self, value):
        if value not in ("normal", "extended"):
            raise ValueError("Invalid cyclic prefix")
        self._cyclic_prefix = value

    @property
    def subcarrier_spacing(self):
        """Subcarrier spacing in kHz (default 15)."""
        self._ifndef("subcarrier_spacing", 15)
        return self._subcarrier_spacing

    @subcarrier_spacing.setter
    def subcarrier_spacing(self, value):
        if value not in _SCS_LIST:
            raise ValueError("Invalid subcarrier spacing")
        self._subcarrier_spacing = value

    @property
    def n_size_grid(self):
        """Number of resource blocks [1..275] (default 4)."""
        self._ifndef("n_size_grid", 4)
        return self._n_size_grid

    @n_size_grid.setter
    def n_size_grid(self, value):
        if value not in range(1, 276):
            raise ValueError(
                "n_size_grid must be in the range from 1 to 275")
        self._n_size_grid = value

    @property
    def n_start_grid(self):
        """Start of resource grid relative to CRB 0 (default 0)."""
        self._ifndef("n_start_grid", 0)
        return self._n_start_grid

    @n_start_grid.setter
    def n_start_grid(self, value):
        if value not in range(0, 2200):
            raise ValueError(
                "n_start_grid must be in the range from 0 to 2199")
        self._n_start_grid = value

    @property
    def slot_number(self):
        """Slot number within a frame (default 0)."""
        self._ifndef("slot_number", 0)
        return self._slot_number

    @slot_number.setter
    def slot_number(self, value):
        if not 0 <= value < self.num_slots_per_frame:
            raise ValueError("slot_number cannot exceed the number of "
                             "slots per frame - 1")
        self._slot_number = value

    @property
    def frame_number(self):
        """System frame number [0..1023] (default 0)."""
        self._ifndef("frame_number", 0)
        return self._frame_number

    @frame_number.setter
    def frame_number(self, value):
        if value not in range(0, 1024):
            raise ValueError("frame_number must be in [0, 1023]")
        self._frame_number = value

    # ------------------------------------------------------------------
    @property
    def num_symbols_per_slot(self):
        return 14 if self.cyclic_prefix == "normal" else 12

    @property
    def num_slots_per_subframe(self):
        return 2 ** self.mu

    @property
    def num_slots_per_frame(self):
        return 10 * self.num_slots_per_subframe

    @property
    def mu(self):
        return _SCS_LIST.index(self.subcarrier_spacing)

    @property
    def frame_duration(self):
        return 10e-3

    @property
    def sub_frame_duration(self):
        return 1e-3

    @property
    def t_c(self):
        return 1 / (480e3 * 4096)

    @property
    def t_s(self):
        return 1 / (15e3 * 2048)

    @property
    def kappa(self):
        return 64.

    @property
    def cyclic_prefix_length(self):
        """Cyclic prefix duration [s]."""
        if self.cyclic_prefix == "extended":
            cp = 512 * self.kappa * 2 ** (-self.mu)
        else:
            cp = 144 * self.kappa * 2 ** (-self.mu)
            if self.slot_number in [0, 7 * 2 ** self.mu]:
                cp += 16 * self.kappa
        return cp * self.t_c

    def check_config(self):
        if self.cyclic_prefix == "extended" \
                and self.subcarrier_spacing != 60:
            raise ValueError("Extended cyclic prefix only valid for "
                             "60kHz subcarrier spacing")
        for attr in ("n_cell_id", "cyclic_prefix", "subcarrier_spacing",
                     "n_size_grid", "slot_number", "frame_number"):
            setattr(self, attr, getattr(self, attr))
