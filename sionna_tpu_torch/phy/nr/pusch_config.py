"""PUSCH configuration per TS 38.211/212/214 (counterpart of
``sionna_tpu/phy/nr/pusch_config.py``).

Plain NumPy on the host, a copy of the JAX package's arithmetic on the
port's own ``generate_prng_seq`` and ``calculate_tb_size``: the DMRS
grids and precoding matrices are float64/complex128 NumPy arrays, as
there; the blocks that take them (``PUSCHPilotPattern``,
``PUSCHPrecoder``) cast them to their own dtype."""

import numpy as np

from .config import Config
from .carrier_config import CarrierConfig
from .pusch_dmrs_config import PUSCHDMRSConfig
from .tb_config import TBConfig
from .utils import generate_prng_seq, calculate_tb_size

__all__ = ["PUSCHConfig", "check_pusch_configs"]


class PUSCHConfig(Config):
    """Full TS 38.211 PUSCH configuration: symbol allocation, DMRS grid
    generation, codebook precoding matrices, transport block pointer."""

    def __init__(self, carrier_config=None, pusch_dmrs_config=None,
                 tb_config=None, **kwargs):
        self._name = "PUSCH Configuration"
        self.carrier = carrier_config
        self.dmrs = pusch_dmrs_config
        self.tb = tb_config
        super().__init__(**kwargs)
        self.check_config()

    # ------------------------------------------------------------------
    # Sub-configurations
    # ------------------------------------------------------------------
    @property
    def carrier(self):
        return self._carrier

    @carrier.setter
    def carrier(self, value):
        if value is None:
            value = CarrierConfig()
        if not isinstance(value, CarrierConfig):
            raise TypeError("carrier must be a CarrierConfig")
        self._carrier = value

    @property
    def dmrs(self):
        return self._dmrs

    @dmrs.setter
    def dmrs(self, value):
        if value is None:
            value = PUSCHDMRSConfig()
        if not isinstance(value, PUSCHDMRSConfig):
            raise TypeError("dmrs must be a PUSCHDMRSConfig")
        self._dmrs = value

    @property
    def tb(self):
        return self._tb

    @tb.setter
    def tb(self, value):
        if value is None:
            value = TBConfig(channel_type="PUSCH")
        if not isinstance(value, TBConfig):
            raise TypeError("tb must be a TBConfig")
        if value.channel_type != "PUSCH":
            raise ValueError("tb must be configured for PUSCH")
        self._tb = value

    # ------------------------------------------------------------------
    # Configurable properties
    # ------------------------------------------------------------------
    @property
    def n_size_bwp(self):
        """Number of RBs in the bandwidth part (None -> carrier
        n_size_grid)."""
        self._ifndef("n_size_bwp", None)
        return self._n_size_bwp

    @n_size_bwp.setter
    def n_size_bwp(self, value):
        if value is not None and value not in range(1, 276):
            raise ValueError("n_size_bwp must be in [1, 275] or None")
        self._n_size_bwp = value

    @property
    def n_start_bwp(self):
        self._ifndef("n_start_bwp", 0)
        return self._n_start_bwp

    @n_start_bwp.setter
    def n_start_bwp(self, value):
        if value not in range(0, 2474):
            raise ValueError("n_start_bwp must be in [0, 2473]")
        self._n_start_bwp = value

    @property
    def num_layers(self):
        self._ifndef("num_layers", 1)
        return self._num_layers

    @num_layers.setter
    def num_layers(self, value):
        if value not in (1, 2, 3, 4):
            raise ValueError("num_layers must be in [1,...,4]")
        self._num_layers = value

    @property
    def num_antenna_ports(self):
        self._ifndef("num_antenna_ports", 1)
        return self._num_antenna_ports

    @num_antenna_ports.setter
    def num_antenna_ports(self, value):
        if value not in (1, 2, 4):
            raise ValueError("num_antenna_ports must be in [1,2,4]")
        self._num_antenna_ports = value

    @property
    def mapping_type(self):
        self._ifndef("mapping_type", "A")
        return self._mapping_type

    @mapping_type.setter
    def mapping_type(self, value):
        if value not in ("A", "B"):
            raise ValueError("mapping_type must be A or B")
        self._mapping_type = value

    @property
    def symbol_allocation(self):
        """[start, length] of allocated OFDM symbols."""
        self._ifndef("symbol_allocation", [0, 14])
        return self._symbol_allocation

    @symbol_allocation.setter
    def symbol_allocation(self, value):
        if len(value) != 2:
            raise ValueError("symbol_allocation must have two elements")
        self._symbol_allocation = list(value)

    @property
    def n_rnti(self):
        self._ifndef("n_rnti", 1)
        return self._n_rnti

    @n_rnti.setter
    def n_rnti(self, value):
        if value not in range(65536):
            raise ValueError("n_rnti must be in [0, 65535]")
        self._n_rnti = value

    @property
    def precoding(self):
        """"non-codebook" (default) | "codebook"."""
        self._ifndef("precoding", "non-codebook")
        return self._precoding

    @precoding.setter
    def precoding(self, value):
        if value not in ("non-codebook", "codebook"):
            raise ValueError(
                "precoding must be non-codebook or codebook")
        self._precoding = value

    @property
    def transform_precoding(self):
        """Transform precoding flag.

        The flag selects the DFT-s-OFDM MCS tables in the MCS/TB-size
        helpers (nr/utils.py); neither package synthesizes the
        DFT-spread waveform itself."""
        self._ifndef("transform_precoding", False)
        return self._transform_precoding

    @transform_precoding.setter
    def transform_precoding(self, value):
        if not isinstance(value, bool):
            raise TypeError("transform_precoding must be bool")
        self._transform_precoding = value

    @property
    def tpmi(self):
        self._ifndef("tpmi", 0)
        return self._tpmi

    @tpmi.setter
    def tpmi(self, value):
        if value not in range(28):
            raise ValueError("tpmi must be in [0, 27]")
        self._tpmi = value

    # ------------------------------------------------------------------
    # Read-only derived properties
    # ------------------------------------------------------------------
    @property
    def frequency_hopping(self):
        return "neither"

    @property
    def l_0(self):
        """First DMRS symbol position relative to l_ref."""
        return self.dmrs.type_a_position if self.mapping_type == "A" \
            else 0

    @property
    def l_d(self):
        return self.symbol_allocation[1]

    @property
    def l_ref(self):
        return 0 if self.mapping_type == "A" \
            else self.symbol_allocation[0]

    @property
    def l_prime(self):
        return [0] if self.dmrs.length == 1 else [0, 1]

    @property
    def l_bar(self):
        """DMRS symbol positions per Tables 6.4.1.1.3-3/4
        TS 38.211."""
        l_0 = self.l_0
        ind = 0 if self.l_d < 4 else self.l_d - 3
        if self.mapping_type == "A":
            if self.dmrs.length == 1:
                table = [
                    [[], [], [], []],
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0, 7], [l_0, 7], [l_0, 7]],
                    [[l_0], [l_0, 7], [l_0, 7], [l_0, 7]],
                    [[l_0], [l_0, 9], [l_0, 6, 9], [l_0, 6, 9]],
                    [[l_0], [l_0, 9], [l_0, 6, 9], [l_0, 6, 9]],
                    [[l_0], [l_0, 9], [l_0, 6, 9], [l_0, 5, 8, 11]],
                    [[l_0], [l_0, 11], [l_0, 7, 11], [l_0, 5, 8, 11]],
                    [[l_0], [l_0, 11], [l_0, 7, 11], [l_0, 5, 8, 11]],
                ]
            else:
                table = [
                    [[], []],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0, 8]],
                    [[l_0], [l_0, 8]],
                    [[l_0], [l_0, 8]],
                    [[l_0], [l_0, 10]],
                    [[l_0], [l_0, 10]],
                ]
        else:
            if self.dmrs.length == 1:
                table = [
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0], [l_0], [l_0]],
                    [[l_0], [l_0, 4], [l_0, 4], [l_0, 4]],
                    [[l_0], [l_0, 4], [l_0, 4], [l_0, 4]],
                    [[l_0], [l_0, 4], [l_0, 4], [l_0, 4]],
                    [[l_0], [l_0, 6], [l_0, 3, 6], [l_0, 3, 6]],
                    [[l_0], [l_0, 6], [l_0, 3, 6], [l_0, 3, 6]],
                    [[l_0], [l_0, 8], [l_0, 4, 8], [l_0, 3, 6, 9]],
                    [[l_0], [l_0, 8], [l_0, 4, 8], [l_0, 3, 6, 9]],
                    [[l_0], [l_0, 10], [l_0, 5, 10], [l_0, 3, 6, 9]],
                    [[l_0], [l_0, 10], [l_0, 5, 10], [l_0, 3, 6, 9]],
                    [[l_0], [l_0, 10], [l_0, 5, 10], [l_0, 3, 6, 9]],
                ]
            else:
                table = [
                    [[], []],
                    [[], []],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0]],
                    [[l_0], [l_0, 5]],
                    [[l_0], [l_0, 5]],
                    [[l_0], [l_0, 7]],
                    [[l_0], [l_0, 7]],
                    [[l_0], [l_0, 9]],
                    [[l_0], [l_0, 9]],
                    [[l_0], [l_0, 9]],
                ]
        return table[ind][self.dmrs.additional_position]

    @property
    def l(self):
        """OFDM symbol indices carrying DMRS relative to l_ref."""
        out = []
        for l_bar in self.l_bar:
            for l_prime in self.l_prime:
                out.append(l_bar + l_prime)
        return out

    @property
    def n(self):
        if self.dmrs.config_type == 1:
            n_max = self.num_resource_blocks * 12 // 4 - 1
        else:
            n_max = self.num_resource_blocks * 12 // 6 - 1
        return list(range(n_max + 1))

    @property
    def dmrs_symbol_indices(self):
        return [l + self.l_ref for l in self.l]

    @property
    def num_resource_blocks(self):
        return self.carrier.n_size_grid if self.n_size_bwp is None \
            else self.n_size_bwp

    @property
    def num_subcarriers(self):
        return 12 * self.num_resource_blocks

    @property
    def num_res_per_prb(self):
        num_dmrs = len(self.dmrs_symbol_indices)
        num_data = self.symbol_allocation[1] - num_dmrs
        if self.dmrs.config_type == 1:
            num_res_dmrs = 12 - 6 * self.dmrs.num_cdm_groups_without_data
        else:
            num_res_dmrs = 12 - 4 * self.dmrs.num_cdm_groups_without_data
        return num_data * 12 + num_dmrs * num_res_dmrs

    @property
    def dmrs_mask(self):
        """[num_subcarriers, num_symbols_per_slot] bool: REs carrying
        no data (DMRS CDM groups without data)."""
        mask = np.zeros([self.num_subcarriers,
                         self.carrier.num_symbols_per_slot], bool)
        num_cdm_groups = self.dmrs.num_cdm_groups_without_data
        if self.dmrs.config_type == 1:
            cdm_ind = np.stack(
                [np.arange(i, 12, 2) for i in range(num_cdm_groups)],
                axis=-1)
        else:
            cdm_ind = np.stack(
                [np.array([0, 1, 6, 7]) + 2 * i
                 for i in range(num_cdm_groups)], axis=-1)
        for i in self.dmrs_symbol_indices:
            for j in range(self.num_resource_blocks):
                for k in range(num_cdm_groups):
                    mask[cdm_ind[:, k] + 12 * j, i] = True
        return mask

    @property
    def dmrs_grid(self):
        """[num_dmrs_ports, num_subcarriers, num_symbols_per_slot]
        complex: per-port resource grid filled with DMRS signals.

        Vectorized evaluation of TS 38.211 Sec. 6.4.1.1: for every
        DMRS symbol the Gold-sequence QPSK reference r(m) is scattered
        onto subcarriers k(n, k') with the per-port frequency shift
        delta and covered by the OCC weights w_f(k') * w_t(l').
        """
        self.check_config()
        dmrs = self.dmrs
        if len(dmrs.dmrs_port_set) == 0:
            # ports default to the first num_layers antenna ports;
            # work on a clone so the user's config stays untouched
            dmrs = dmrs.clone()
            dmrs.dmrs_port_set = list(range(self.num_layers))

        num_ports = len(dmrs.dmrs_port_set)
        num_sc = self.num_subcarriers
        grid = np.zeros([num_ports, num_sc,
                         self.carrier.num_symbols_per_slot], complex)

        # Static index maps, shared by all DMRS symbols.
        n = np.asarray(self.n)                                  # [N]
        kp = np.arange(2)                                       # [2]
        delta = np.asarray(dmrs.deltas)                         # [P]
        if dmrs.config_type == 1:
            k_nk = 4 * n[:, None] + 2 * kp[None, :]             # [N,2]
        else:
            k_nk = 6 * n[:, None] + kp[None, :]
        k_pnk = k_nk[None] + delta[:, None, None]           # [P,N,2]
        m_nk = 2 * n[:, None] + kp[None, :]                     # [N,2]
        wf_pk = np.asarray(dmrs.w_f).T[:, None, :]          # [P,1,2]
        p_idx = np.arange(num_ports)[:, None, None]

        for l_prime in self.l_prime:
            wt_p = np.asarray(dmrs.w_t)[l_prime]                # [P]
            for l_bar in self.l_bar:
                l = l_bar + l_prime
                c = generate_prng_seq(2 * num_sc, self.c_init(l))
                r = ((1. - 2. * c[0::2])
                     + 1j * (1. - 2. * c[1::2])) / np.sqrt(2.)
                vals = (r[m_nk][None] * wf_pk
                        * wt_p[:, None, None])              # [P,N,2]
                grid[p_idx, k_pnk, self.l_ref + l] = vals
        return dmrs.beta * grid

    @property
    def dmrs_grid_precoded(self):
        """[num_antenna_ports, num_subcarriers, num_symbols_per_slot]
        complex: codebook-precoded DMRS grid (None for non-codebook
        transmission)."""
        if self.precoding == "non-codebook":
            return None
        return np.einsum("pl,lkt->pkt", self.precoding_matrix,
                         self.dmrs_grid)

    @property
    def precoding_matrix(self):
        """[num_antenna_ports, num_layers] codebook precoder per
        Tables 6.3.1.5-1..7 TS 38.211."""
        if self.precoding == "non-codebook" \
                or self.num_antenna_ports == 1:
            return None
        w = None
        if self.num_layers == 1:
            if self.num_antenna_ports == 2:
                w = np.zeros([6, 2, 1], complex)
                w[:, 0, 0] = [1, 0, 1, 1, 1, 1]
                w[:, 1, 0] = [0, 1, 1, -1, 1j, -1j]
                w /= np.sqrt(2)
            elif self.num_antenna_ports == 4:
                w = np.zeros([28, 4, 1], complex)
                w[:8, 0, 0] = [1, 0, 0, 0, 1, 1, 1, 1]
                w[:8, 1, 0] = [0, 1, 0, 0, 0, 0, 0, 0]
                w[:8, 2, 0] = [0, 0, 1, 0, 1, -1, 1j, -1j]
                w[:8, 3, 0] = [0, 0, 0, 1, 0, 0, 0, 0]
                w[8:16, 0, 0] = [0, 0, 0, 0, 1, 1, 1, 1]
                w[8:16, 1, 0] = [1, 1, 1, 1, 1, 1, 1, 1]
                w[8:16, 2, 0] = [0, 0, 0, 0, 1, 1j, -1, -1j]
                w[8:16, 3, 0] = [1, -1, 1j, -1j, 1, 1j, -1, -1j]
                w[16:24, 0, 0] = [1, 1, 1, 1, 1, 1, 1, 1]
                w[16:24, 1, 0] = [1j, 1j, 1j, 1j, -1, -1, -1, -1]
                w[16:24, 2, 0] = [1, 1j, -1, -1j, 1, 1j, -1, -1j]
                w[16:24, 3, 0] = [1j, -1, -1j, 1, -1, -1j, 1, 1j]
                w[24:28, 0, 0] = [1, 1, 1, 1]
                w[24:28, 1, 0] = [-1j, -1j, -1j, -1j]
                w[24:28, 2, 0] = [1, 1j, -1, -1j]
                w[24:28, 3, 0] = [-1j, 1, 1j, -1]
                w /= 2
        elif self.num_layers == 2:
            if self.num_antenna_ports == 2:
                w = np.zeros([3, 2, 2], complex)
                w[0] = np.array([[1, 0], [0, 1]]) / np.sqrt(2)
                w[1] = np.array([[1, 1], [1, -1]]) / 2
                w[2] = np.array([[1, 1], [1j, -1j]]) / 2
            elif self.num_antenna_ports == 4:
                w = np.zeros([22, 4, 2], complex)
                base = [
                    [[1, 0], [0, 1], [0, 0], [0, 0]],
                    [[1, 0], [0, 0], [0, 1], [0, 0]],
                    [[1, 0], [0, 0], [0, 0], [0, 1]],
                    [[0, 0], [1, 0], [0, 1], [0, 0]],
                    [[0, 0], [1, 0], [0, 0], [0, 1]],
                    [[0, 0], [0, 0], [1, 0], [0, 1]],
                    [[1, 0], [0, 1], [1, 0], [0, -1j]],
                    [[1, 0], [0, 1], [1, 0], [0, 1j]],
                    [[1, 0], [0, 1], [-1j, 0], [0, 1]],
                    [[1, 0], [0, 1], [-1j, 0], [0, -1]],
                    [[1, 0], [0, 1], [-1, 0], [0, -1j]],
                    [[1, 0], [0, 1], [-1, 0], [0, 1j]],
                    [[1, 0], [0, 1], [1j, 0], [0, 1]],
                    [[1, 0], [0, 1], [1j, 0], [0, -1]],
                ]
                for i, b in enumerate(base):
                    w[i] = np.array(b) / 2
                base2 = [
                    [[1, 1], [1, 1], [1, -1], [1, -1]],
                    [[1, 1], [1, 1], [1j, -1j], [1j, -1j]],
                    [[1, 1], [1j, 1j], [1, -1], [1j, -1j]],
                    [[1, 1], [1j, 1j], [1j, -1j], [-1, 1]],
                    [[1, 1], [-1, -1], [1, -1], [-1, 1]],
                    [[1, 1], [-1, -1], [1j, -1j], [-1j, 1j]],
                    [[1, 1], [-1j, -1j], [1, -1], [-1j, 1j]],
                    [[1, 1], [-1j, -1j], [1j, -1j], [1, -1]],
                ]
                for i, b in enumerate(base2):
                    w[14 + i] = np.array(b) / (2 * np.sqrt(2))
        elif self.num_layers == 3:
            if self.num_antenna_ports == 4:
                w = np.zeros([7, 4, 3], complex)
                w[0] = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                 [0, 0, 0]]) / 2
                w[1] = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0],
                                 [0, 0, 1]]) / 2
                w[2] = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0],
                                 [0, 0, 1]]) / 2
                w[3] = np.array([[1, 1, 1], [1, -1, 1], [1, 1, -1],
                                 [1, -1, -1]]) / (2 * np.sqrt(3))
                w[4] = np.array([[1, 1, 1], [1, -1, 1], [1j, 1j, -1j],
                                 [1j, -1j, -1j]]) / (2 * np.sqrt(3))
                w[5] = np.array([[1, 1, 1], [-1, 1, -1], [1, 1, -1],
                                 [-1, 1, 1]]) / (2 * np.sqrt(3))
                w[6] = np.array([[1, 1, 1], [-1, 1, -1], [1j, 1j, -1j],
                                 [-1j, 1j, 1j]]) / (2 * np.sqrt(3))
        elif self.num_layers == 4:
            if self.num_antenna_ports == 4:
                w = np.zeros([5, 4, 4], complex)
                w[0] = np.eye(4) / 2
                w[1] = np.array([[1, 1, 0, 0], [0, 0, 1, 1],
                                 [1, -1, 0, 0], [0, 0, 1, -1]]) \
                    / (2 * np.sqrt(2))
                w[2] = np.array([[1, 1, 0, 0], [0, 0, 1, 1],
                                 [1j, -1j, 0, 0], [0, 0, 1j, -1j]]) \
                    / (2 * np.sqrt(2))
                w[3] = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                                 [1, 1, -1, -1], [1, -1, -1, 1]]) / 4
                w[4] = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                                 [1j, 1j, -1j, -1j],
                                 [1j, -1j, -1j, 1j]]) / 4
        if w is None:
            return None
        return w[self.tpmi]

    @property
    def num_ov(self):
        return 0

    @property
    def num_coded_bits(self):
        n_re = (self.num_res_per_prb - self.num_ov) \
            * self.num_resource_blocks
        return int(self.tb.tb_scaling * self.tb.num_bits_per_symbol
                   * self.num_layers * n_re)

    @property
    def tb_size(self):
        n_re_per_prb = self.num_res_per_prb - self.num_ov
        n_re = min(156, n_re_per_prb) * self.num_resource_blocks
        target_tb_size = int(self.tb.target_coderate
                             * self.tb.tb_scaling * n_re
                             * self.tb.num_bits_per_symbol
                             * self.num_layers)
        tb_size, *_ = calculate_tb_size(
            target_tb_size=target_tb_size,
            num_coded_bits=self.num_coded_bits,
            target_coderate=self.tb.target_coderate,
            modulation_order=self.tb.num_bits_per_symbol,
            verbose=False)
        return int(tb_size)

    # ------------------------------------------------------------------
    def c_init(self, l):
        """DMRS sequence RNG init (TS 38.211 Eq. 6.4.1.1.1)."""
        num_symbols_per_slot = self.carrier.num_symbols_per_slot
        slot_number = self.carrier.slot_number
        lambda_bar = 0
        n_scid_bar = self.dmrs.n_scid
        if self.dmrs.n_id is None:
            n_id = self.carrier.n_cell_id
        else:
            n_id = self.dmrs.n_id[n_scid_bar]
        c_init = np.mod(
            2 ** 17 * (num_symbols_per_slot * slot_number + l + 1)
            * (2 * n_id + 1)
            + 2 ** 17 * np.floor(lambda_bar / 2)
            + 2 * n_id + n_scid_bar, 2 ** 31)
        return int(c_init)

    def show(self):
        self.carrier.show()
        Config.show(self)
        self.dmrs.show()
        self.tb.show()

    def check_config(self):
        self.carrier.check_config()
        self.dmrs.check_config()
        if self.precoding == "codebook":
            if len(self.dmrs.dmrs_port_set) > 0 \
                    and len(self.dmrs.dmrs_port_set) != self.num_layers:
                raise ValueError("num_layers must be equal to the "
                                 "number of dmrs ports")
            if self.num_layers > self.num_antenna_ports:
                raise ValueError(
                    "num_layers must be <= num_antenna_ports")
            if self.num_antenna_ports < 2:
                raise ValueError(
                    "precoding requires two or more antenna ports")
        else:
            if self.num_layers != self.num_antenna_ports:
                raise ValueError(
                    "num_layers must be == num_antenna_ports")
        if self.dmrs.length == 1:
            if self.mapping_type == "A" \
                    and self.symbol_allocation[1] < 4:
                raise ValueError("Symbol allocation is too short")
        else:
            if self.dmrs.additional_position >= 2:
                raise ValueError("dmrs.additional_position must be <2 "
                                 "for this dmrs.length")
            if self.symbol_allocation[1] < 4:
                raise ValueError("Symbol allocation too short")
            if self.mapping_type == "B" \
                    and self.symbol_allocation[1] < 5:
                raise ValueError("Symbol allocation is too short")
        if self.mapping_type == "A" \
                and self.dmrs.additional_position == 3 \
                and self.dmrs.type_a_position != 2:
            raise ValueError("additional_position=3 only allowed for "
                             "type_a_position=2")
        # valid TPMI ranges
        tpmi_max = {(1, 2): 6, (1, 4): 28, (2, 2): 3, (2, 4): 22,
                    (3, 4): 7, (4, 4): 5}
        key = (self.num_layers, self.num_antenna_ports)
        if self.precoding == "codebook" and key in tpmi_max \
                and self.tpmi >= tpmi_max[key]:
            raise ValueError(f"tpmi must be < {tpmi_max[key]}")
        max_length = 14 if self.carrier.cyclic_prefix == "normal" \
            else 12
        if self.mapping_type == "A":
            if self.symbol_allocation[0] != 0:
                raise ValueError("symbol_allocation[0] must be 0 for "
                                 "mapping_type A")
            if not 4 <= self.symbol_allocation[1] <= max_length:
                raise ValueError(
                    "symbol_allocation[1] must be in [4, 14 (or 12)]")
        else:
            if not 0 <= self.symbol_allocation[0] <= 13:
                raise ValueError("symbol_allocation[0] must be in "
                                 "[0,13] for mapping_type B")
            if not 1 <= self.symbol_allocation[1] <= max_length:
                raise ValueError(
                    "symbol_allocation[1] must be in [1, 14 (or 12)]")
        if self.symbol_allocation[0] + self.symbol_allocation[1] \
                > max_length:
            raise ValueError("symbol_allocation[0]+symbol_allocation[1]"
                             " must be <= 14 (or 12)")
        for attr in ("n_size_bwp", "n_start_bwp", "num_layers",
                     "mapping_type", "symbol_allocation", "n_rnti",
                     "precoding", "transform_precoding", "tpmi"):
            setattr(self, attr, getattr(self, attr))
        if self.tb.channel_type != "PUSCH":
            raise ValueError(
                'TB config must be configured for "PUSCH".')
        if len(self.dmrs.dmrs_port_set) > 0 \
                and self.num_layers != len(self.dmrs.dmrs_port_set):
            raise ValueError(
                "num_layers must equal the number of DMRS ports")
        return True


def check_pusch_configs(pusch_configs):
    """Validates a list of PUSCHConfigs for multi-transmitter use and
    extracts common parameters."""
    if not isinstance(pusch_configs, list):
        raise TypeError("pusch_configs must be a list")
    for pc in pusch_configs:
        if not isinstance(pc, PUSCHConfig):
            raise TypeError("Each element must be a PUSCHConfig")
        pc.check_config()

    pc = pusch_configs[0]
    carrier = pc.carrier
    params = {
        "num_bits_per_symbol": pc.tb.num_bits_per_symbol,
        "num_tx": len(pusch_configs),
        "num_layers": pc.num_layers,
        "num_subcarriers": pc.num_subcarriers,
        "num_ofdm_symbols": pc.symbol_allocation[1],
        "subcarrier_spacing": pc.carrier.subcarrier_spacing * 1e3,
        "num_antenna_ports": pc.num_antenna_ports,
        "precoding": pc.precoding,
        "precoding_matrices": [],
        "pusch_config": pc,
        "carrier_config": pc.carrier,
        "num_coded_bits": pc.num_coded_bits,
        "target_coderate": pc.tb.target_coderate,
        "n_id": [],
        "n_rnti": [],
        "tb_size": pc.tb_size,
        "dmrs_length": pc.dmrs.length,
        "dmrs_additional_position": pc.dmrs.additional_position,
        "num_cdm_groups_without_data":
            pc.dmrs.num_cdm_groups_without_data,
    }
    params["bandwidth"] = (params["num_subcarriers"]
                           * params["subcarrier_spacing"])
    params["cyclic_prefix_length"] = int(np.ceil(
        carrier.cyclic_prefix_length * params["bandwidth"]))
    for pc_i in pusch_configs:
        if params["precoding"] == "codebook":
            params["precoding_matrices"].append(pc_i.precoding_matrix)
        if pc_i.tb.n_id is None:
            params["n_id"].append(pc_i.carrier.n_cell_id)
        else:
            params["n_id"].append(pc_i.tb.n_id)
        params["n_rnti"].append(pc_i.n_rnti)
    return params
