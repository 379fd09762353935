"""PUSCH DMRS to PilotPattern adapter (counterpart of
``sionna_tpu/phy/nr/pusch_pilot_pattern.py``): plain NumPy on the host,
the DMRS grids cast to the pattern's complex dtype."""

import warnings

import numpy as np

from ..ofdm import PilotPattern
from .pusch_config import PUSCHConfig

__all__ = ["PUSCHPilotPattern"]


class PUSCHPilotPattern(PilotPattern):
    """Builds a :class:`PilotPattern` from PUSCH configurations (one
    per transmitter)."""

    def __init__(self, pusch_configs, precision=None):
        if isinstance(pusch_configs, PUSCHConfig):
            pusch_configs = [pusch_configs]
        for c in pusch_configs:
            if not isinstance(c, PUSCHConfig):
                raise TypeError("Each element of pusch_configs must "
                                "be a valid PUSCHConfig")
        num_tx = len(pusch_configs)
        num_streams_per_tx = pusch_configs[0].num_layers
        dmrs_grid = pusch_configs[0].dmrs_grid
        num_subcarriers = dmrs_grid[0].shape[0]
        num_ofdm_symbols = pusch_configs[0].l_d
        precoding = pusch_configs[0].precoding
        num_pilots = int(np.sum(pusch_configs[0].dmrs_mask))
        dmrs_ports = []
        for pc in pusch_configs:
            if pc.num_layers != num_streams_per_tx:
                raise ValueError("All pusch_configs must have the same "
                                 "number of layers")
            if pc.dmrs_grid[0].shape[0] != num_subcarriers:
                raise ValueError("All pusch_configs must have the same "
                                 "number of subcarriers")
            if pc.l_d != num_ofdm_symbols:
                raise ValueError("All pusch_configs must have the same "
                                 "number of OFDM symbols")
            if pc.precoding != precoding:
                raise ValueError("All pusch_configs must have the same "
                                 "precoding method")
            if int(np.sum(pc.dmrs_mask)) != num_pilots:
                raise ValueError("All pusch_configs must have the same "
                                 "number of masked REs")
            for port in pc.dmrs.dmrs_port_set:
                if port in dmrs_ports:
                    warnings.warn(
                        f"DMRS port {port} used by multiple "
                        f"transmitters")
            dmrs_ports += pc.dmrs.dmrs_port_set

        mask = np.zeros([num_tx, num_streams_per_tx, num_ofdm_symbols,
                         num_subcarriers], bool)
        pilots = np.zeros([num_tx, num_streams_per_tx, num_pilots],
                          complex)
        for i, pc in enumerate(pusch_configs):
            grid = pc.dmrs_grid
            for j in range(num_streams_per_tx):
                ind0, ind1 = pc.symbol_allocation
                mask[i, j] = np.transpose(
                    pc.dmrs_mask[:, ind0:ind0 + ind1])
                g = np.transpose(grid[j, :, ind0:ind0 + ind1])
                pilots[i, j] = g[np.where(mask[i, j])]
        super().__init__(mask, pilots, normalize=False,
                         precision=precision)
