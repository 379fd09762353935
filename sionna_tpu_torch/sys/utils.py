"""SYS utility functions (counterpart of ``sionna_tpu/sys/utils.py``)."""

import functools

import numpy as np
import torch

from ..phy.utils.misc import _rdtype
from ..phy.utils.tensors import insert_dims

__all__ = ["is_scheduled_in_slot", "get_pathloss",
           "spread_across_subcarriers"]


def is_scheduled_in_slot(sinr=None, num_allocated_re=None):
    """Whether each user is scheduled in a slot.

    sinr: [..., sym, sc, ut, streams] or num_allocated_re: [..., ut].
    Returns bool [..., ut]."""
    if (sinr is None) == (num_allocated_re is None):
        raise ValueError("Either 'sinr' or 'num_allocated_re' is "
                         "required as input")
    if sinr is not None:
        return torch.sum(torch.as_tensor(sinr), dim=(-4, -3, -1)) > 0
    return torch.as_tensor(num_allocated_re) > 0


@functools.lru_cache(maxsize=16)
def _serving_pairs(assoc_bytes, shape, device):
    """Flat (rx, tx) indices of the serving pairs of an association, on
    ``device``: made once per association and device."""
    assoc = np.frombuffer(assoc_bytes, dtype=np.int64).reshape(shape)
    rx_idx, tx_idx = np.nonzero(assoc == 1)
    return torch.as_tensor(rx_idx * shape[1] + tx_idx, device=device)


def get_pathloss(h_freq, rx_tx_association=None, precision=None):
    """Pathloss per RX-TX pair, and per user on its serving link, from
    OFDM channel coefficients.

    h_freq: [..., rx, rxa, tx, txa, sym, sc]; rx_tx_association: a
    binary [rx, tx] array (host). Returns (pathloss_all_pairs [..., rx,
    tx, sym], pathloss_serving_tx [..., num_ut, sym] or None)."""
    rdtype = _rdtype(precision)
    h_freq = torch.as_tensor(h_freq)
    rx_power = torch.abs(h_freq) ** 2
    # mean over subcarriers, tx antennas, rx antennas
    rx_power = torch.mean(rx_power, dim=(-1, -3, -5)).to(rdtype)
    pathloss_all_pairs = torch.where(rx_power > 0., 1. / rx_power,
                                     torch.full_like(rx_power, np.inf))
    if rx_tx_association is None:
        return pathloss_all_pairs, None

    if isinstance(rx_tx_association, torch.Tensor):
        rx_tx_association = rx_tx_association.cpu().numpy()
    assoc = np.asarray(rx_tx_association)
    if not np.all(np.isin(assoc, [0, 1])):
        raise ValueError("rx_tx_association must contain binary values")
    assoc = assoc.astype(np.int64)
    idx = _serving_pairs(assoc.tobytes(), assoc.shape,
                         pathloss_all_pairs.device)
    # [..., num_ut, sym]
    serving = pathloss_all_pairs.flatten(-3, -2).index_select(-2, idx)
    return pathloss_all_pairs, serving


def spread_across_subcarriers(tx_power_per_ut, is_scheduled, num_tx=None,
                              precision=None):
    """Uniformly distributes each user's power over its allocated
    subcarriers and streams in each OFDM symbol.

    tx_power_per_ut: [..., sym, ut]; is_scheduled: [..., sym, sc, ut,
    streams]. Returns [..., num_tx, streams_per_tx, sym, sc]."""
    rdtype = _rdtype(precision)
    tx_power_per_ut = torch.as_tensor(tx_power_per_ut).to(rdtype)
    is_scheduled = torch.as_tensor(is_scheduled).to(torch.bool)
    num_sym, num_sc, num_ut, _ = is_scheduled.shape[-4:]
    lbs = is_scheduled.dim() - 4
    if num_tx is None:
        num_tx = num_ut

    # [..., sym, ut, sc, streams]
    perm = tuple(range(lbs)) + (lbs, lbs + 2, lbs + 1, lbs + 3)
    is_scheduled = is_scheduled.permute(perm)

    tx_power = insert_dims(tx_power_per_ut, 2, axis=-1)
    zero = torch.zeros((), dtype=rdtype, device=tx_power.device)
    tx_power = torch.where(is_scheduled, tx_power, zero)

    num_allocated_re = torch.sum(is_scheduled.to(torch.int32),
                                 dim=(-2, -1))
    num_allocated_re = insert_dims(num_allocated_re, 2, axis=-1)
    tx_power = torch.where(num_allocated_re > 0,
                           tx_power / num_allocated_re.to(rdtype), zero)

    # [..., ut, streams, sym, sc]
    perm = tuple(range(lbs)) + (lbs + 1, lbs + 3, lbs, lbs + 2)
    tx_power = tx_power.permute(perm)
    return tx_power.reshape(tuple(tx_power.shape[:-4])
                            + (num_tx, -1, num_sym, num_sc))
