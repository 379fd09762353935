"""PUSCH DMRS configuration (counterpart of
``sionna_tpu/phy/nr/pusch_dmrs_config.py``; TS 38.211 Sec. 6.4.1.1).
Plain NumPy, a copy of the JAX package's."""

import numpy as np

from .config import Config

__all__ = ["PUSCHDMRSConfig"]


class PUSCHDMRSConfig(Config):
    """DMRS type/length/positions/CDM groups for PUSCH."""

    def __init__(self, **kwargs):
        self._name = "PUSCH-DMRS Configuration"
        super().__init__(**kwargs)
        self.check_config()

    @property
    def config_type(self):
        """DMRS configuration type 1 | 2 (default 1)."""
        self._ifndef("config_type", 1)
        return self._config_type

    @config_type.setter
    def config_type(self, value):
        if value not in (1, 2):
            raise ValueError("config_type must be in [1,2]")
        self._config_type = value

    @property
    def type_a_position(self):
        """First DMRS symbol position for mapping type A: 2 | 3."""
        self._ifndef("type_a_position", 2)
        return self._type_a_position

    @type_a_position.setter
    def type_a_position(self, value):
        if value not in (2, 3):
            raise ValueError("type_a_position must be in [2,3]")
        self._type_a_position = value

    @property
    def additional_position(self):
        """Number of additional DMRS positions 0..3 (default 0)."""
        self._ifndef("additional_position", 0)
        return self._additional_position

    @additional_position.setter
    def additional_position(self, value):
        if value not in (0, 1, 2, 3):
            raise ValueError("additional_position must be in [0,1,2,3]")
        self._additional_position = value

    @property
    def length(self):
        """Number of front-loaded DMRS symbols 1 | 2 (default 1)."""
        self._ifndef("length", 1)
        return self._length

    @length.setter
    def length(self, value):
        if value not in (1, 2):
            raise ValueError("Invalid DMRS length")
        self._length = value

    @property
    def dmrs_port_set(self):
        """List of DMRS ports (default [] -> derived by PUSCHConfig)."""
        self._ifndef("dmrs_port_set", [])
        return self._dmrs_port_set

    @dmrs_port_set.setter
    def dmrs_port_set(self, value):
        if not isinstance(value, (list, tuple)):
            value = [value]
        self._dmrs_port_set = list(value)

    @property
    def n_id(self):
        """Scrambling identities: None | int | 2-tuple (default None ->
        derived from carrier n_cell_id)."""
        self._ifndef("n_id", None)
        return self._n_id

    @n_id.setter
    def n_id(self, value):
        if value is None:
            self._n_id = None
        elif isinstance(value, int):
            if value not in range(65536):
                raise ValueError("n_id must be in [0, 65535]")
            self._n_id = [value, value]
        else:
            if len(value) != 2:
                raise ValueError("n_id must be either [] or a two-tuple")
            for e in value:
                if e not in range(65536):
                    raise ValueError("n_id must be in [0, 65535]")
            self._n_id = list(value)

    @property
    def n_scid(self):
        """Scrambling initialization 0 | 1 (default 0)."""
        self._ifndef("n_scid", 0)
        return self._n_scid

    @n_scid.setter
    def n_scid(self, value):
        if value not in (0, 1):
            raise ValueError("n_scid must be 0 or 1")
        self._n_scid = value

    @property
    def num_cdm_groups_without_data(self):
        """1 | 2 | 3 (default 2)."""
        self._ifndef("num_cdm_groups_without_data", 2)
        return self._num_cdm_groups_without_data

    @num_cdm_groups_without_data.setter
    def num_cdm_groups_without_data(self, value):
        if value not in (1, 2, 3):
            raise ValueError(
                "num_cdm_groups_without_data must be in [1,2,3]")
        self._num_cdm_groups_without_data = value

    # ------------------------------------------------------------------
    @property
    def allowed_dmrs_ports(self):
        """Nominal antenna ports for the configuration."""
        if self.length == 1:
            if self.config_type == 1:
                return [0, 1] if self.num_cdm_groups_without_data == 1 \
                    else [0, 1, 2, 3]
            if self.num_cdm_groups_without_data == 1:
                return [0, 1]
            if self.num_cdm_groups_without_data == 2:
                return [0, 1, 2, 3]
            return [0, 1, 2, 3, 4, 5]
        if self.config_type == 1:
            return [0, 1, 4, 5] if self.num_cdm_groups_without_data == 1 \
                else [0, 1, 2, 3, 4, 5, 6, 7]
        if self.num_cdm_groups_without_data == 1:
            return [0, 1, 6, 7]
        if self.num_cdm_groups_without_data == 2:
            return [0, 1, 2, 3, 6, 7, 8, 9]
        return list(range(12))

    @property
    def cdm_groups(self):
        """CDM group lambda per port (Tables 6.4.1.1.3-1/2)."""
        cdm = [0, 0, 1, 1, 0, 0, 1, 1] if self.config_type == 1 \
            else [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2]
        return [cdm[p] for p in self.dmrs_port_set]

    @property
    def deltas(self):
        """Frequency shifts per port (Tables 6.4.1.1.3-1/2)."""
        d = [0, 0, 1, 1, 0, 0, 1, 1] if self.config_type == 1 \
            else [0, 0, 2, 2, 4, 4, 0, 0, 2, 2, 4, 4]
        return [d[p] for p in self.dmrs_port_set]

    @property
    def w_f(self):
        """Frequency weight vectors per port."""
        n = 8 if self.config_type == 1 else 12
        w = np.array([[1] * n, [1, -1] * (n // 2)])
        return w[:, self.dmrs_port_set]

    @property
    def w_t(self):
        """Time weight vectors per port."""
        if self.config_type == 1:
            w = np.array([[1] * 8, [1, 1, 1, 1, -1, -1, -1, -1]])
        else:
            w = np.array([[1] * 12, [1] * 6 + [-1] * 6])
        return w[:, self.dmrs_port_set]

    @property
    def beta(self):
        """PUSCH-to-DMRS EPRE ratio (Table 6.2.2-1 TS 38.214)."""
        if self.num_cdm_groups_without_data == 1:
            return 1.0
        if self.num_cdm_groups_without_data == 2:
            return np.sqrt(2)
        if self.config_type == 2:
            return np.sqrt(3)
        return None

    def check_config(self):
        if self.length == 2 and self.additional_position not in (0, 1):
            raise ValueError(
                "additional_position must be in [0, 1] for length==2")
        for p in self.dmrs_port_set:
            if p not in self.allowed_dmrs_ports:
                raise ValueError(
                    f"Unallowed DMRS port {p}. Not in "
                    f"{self.allowed_dmrs_ports}.")
        if self.config_type == 1 \
                and self.num_cdm_groups_without_data not in (1, 2):
            raise ValueError("num_cdm_groups_without_data must be in "
                             "[1,2] for config_type 1")
        for attr in ("config_type", "type_a_position",
                     "additional_position", "length", "dmrs_port_set",
                     "n_id", "n_scid", "num_cdm_groups_without_data"):
            setattr(self, attr, getattr(self, attr))
