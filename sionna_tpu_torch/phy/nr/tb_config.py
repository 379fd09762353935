"""Transport block configuration (counterpart of
``sionna_tpu/phy/nr/tb_config.py``; TS 38.214). Plain Python on the
port's own ``decode_mcs_index``."""

from .config import Config
from .utils import decode_mcs_index

__all__ = ["TBConfig"]


class TBConfig(Config):
    """MCS table/index and channel-type selection for transport
    blocks."""

    def __init__(self, **kwargs):
        self._name = "TB Configuration"
        super().__init__(**kwargs)
        self.check_config()

    @property
    def mcs_index(self):
        """MCS index [0..28] (default 14)."""
        self._ifndef("mcs_index", 14)
        return self._mcs_index

    @mcs_index.setter
    def mcs_index(self, value):
        if value not in range(29):
            raise ValueError("mcs_index must be in [0, 28]")
        self._mcs_index = value

    @property
    def mcs_table(self):
        """MCS table index [1..4] (default 1)."""
        self._ifndef("mcs_table", 1)
        return self._mcs_table

    @mcs_table.setter
    def mcs_table(self, value):
        if value not in range(1, 5):
            raise ValueError("mcs_table must be in [1, 4]")
        self._mcs_table = value

    @property
    def channel_type(self):
        """"PUSCH" (default) | "PDSCH"."""
        self._ifndef("channel_type", "PUSCH")
        return self._channel_type

    @channel_type.setter
    def channel_type(self, value):
        if value not in ("PUSCH", "PDSCH"):
            raise ValueError("channel_type must be PUSCH or PDSCH")
        self._channel_type = value

    @property
    def n_id(self):
        """Data scrambling id [0..1023] | None (default ->
        derived from cell id)."""
        self._ifndef("n_id", None)
        return self._n_id

    @n_id.setter
    def n_id(self, value):
        if value is not None and value not in range(1024):
            raise ValueError("n_id must be in [0, 1023] or None")
        self._n_id = value

    @property
    def target_coderate(self):
        """Target code rate from the MCS tables."""
        _, rate = decode_mcs_index(
            self.mcs_index, self.mcs_table,
            is_pusch=self.channel_type == "PUSCH")
        return float(rate)

    @property
    def num_bits_per_symbol(self):
        """Modulation order from the MCS tables."""
        mod, _ = decode_mcs_index(
            self.mcs_index, self.mcs_table,
            is_pusch=self.channel_type == "PUSCH")
        return int(mod)

    @property
    def tb_scaling(self):
        """TB scaling factor (fixed to 1.0)."""
        return 1.0

    def check_config(self):
        for attr in ("mcs_index", "mcs_table", "channel_type", "n_id"):
            setattr(self, attr, getattr(self, attr))
