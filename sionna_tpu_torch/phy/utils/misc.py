"""Miscellaneous utilities (counterpart of ``sionna_tpu/phy/utils/misc.py``;
the slice needs ``ebnodb2no`` and ``hard_decisions``)."""

import torch

from ..config import config, dtypes


def ebnodb2no(ebno_db, num_bits_per_symbol, coderate, resource_grid=None,
              precision=None):
    """Noise variance ``No`` for a given ``Eb/No`` in dB, accounting for
    coderate and bits per symbol. A Python number gives a CPU tensor; a
    tensor keeps its device."""
    if resource_grid is not None:
        raise NotImplementedError(
            "ebnodb2no(resource_grid=...) needs the OFDM resource grid, "
            "which is not ported yet (ROADMAP.md, queue 1 item 8)")
    rdtype = config.rdtype if precision is None \
        else dtypes[precision]["torch"]["rdtype"]
    ebno_db = torch.as_tensor(ebno_db).to(rdtype)
    dev = ebno_db.device
    ebno = torch.pow(torch.tensor(10.0, dtype=rdtype, device=dev),
                     ebno_db / 10)
    coderate = torch.tensor(coderate, dtype=rdtype, device=dev)
    nbps = torch.tensor(num_bits_per_symbol, dtype=rdtype, device=dev)
    energy_per_symbol = torch.tensor(1.0, dtype=rdtype, device=dev)
    return 1 / (ebno * coderate * nbps / energy_per_symbol)


def hard_decisions(llr):
    """Elementwise hard decision: 1 if llr > 0 else 0, same dtype as
    the input."""
    llr = torch.as_tensor(llr)
    return (llr > 0).to(llr.dtype)
