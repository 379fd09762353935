"""Miscellaneous utilities (counterpart of ``sionna_tpu/phy/utils/misc.py``;
the port needs ``ebnodb2no`` and ``hard_decisions``)."""

import torch

from ..config import config, dtypes


def ebnodb2no(ebno_db, num_bits_per_symbol, coderate, resource_grid=None,
              precision=None):
    """Noise variance ``No`` for a given ``Eb/No`` in dB, accounting for
    coderate, bits per symbol and, with ``resource_grid``, the OFDM
    overheads (cyclic prefix, pilots, streams). A Python number gives a
    CPU tensor; a tensor keeps its device."""
    rdtype = config.rdtype if precision is None \
        else dtypes[precision]["torch"]["rdtype"]
    ebno_db = torch.as_tensor(ebno_db).to(rdtype)
    dev = ebno_db.device
    ebno = torch.pow(torch.tensor(10.0, dtype=rdtype, device=dev),
                     ebno_db / 10)
    energy_per_symbol = 1.0
    if resource_grid is not None:
        energy_per_symbol /= resource_grid.num_streams_per_tx
        cp_overhead = (resource_grid.cyclic_prefix_length
                       / resource_grid.fft_size)
        num_syms = (resource_grid.num_ofdm_symbols * (1 + cp_overhead)
                    * resource_grid.num_effective_subcarriers)
        energy_per_symbol *= num_syms / resource_grid.num_data_symbols
    coderate = torch.tensor(coderate, dtype=rdtype, device=dev)
    nbps = torch.tensor(num_bits_per_symbol, dtype=rdtype, device=dev)
    energy_per_symbol = torch.tensor(energy_per_symbol, dtype=rdtype,
                                     device=dev)
    return 1 / (ebno * coderate * nbps / energy_per_symbol)


def hard_decisions(llr):
    """Elementwise hard decision: 1 if llr > 0 else 0, same dtype as
    the input."""
    llr = torch.as_tensor(llr)
    return (llr > 0).to(llr.dtype)
