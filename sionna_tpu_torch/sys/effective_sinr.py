"""Effective SINR mapping (counterpart of
``sionna_tpu/sys/effective_sinr.py``). The EESM beta table is read from
the JAX package's JSON file, by path, and held on the block's device."""

import json
from abc import abstractmethod
from pathlib import Path

import numpy as np
import torch

from ..phy.block import Block
from ..phy.utils.misc import (DeepUpdateDict, dict_keys_to_int, to_list,
                              scalar_to_shaped_tensor)
from ..phy.utils.tensors import expand_to_rank, gather_from_batched_indices

__all__ = ["EffectiveSINR", "EESM"]

_ESM_DIR = (Path(__file__).resolve().parents[2] / "sionna_tpu" / "sys"
            / "esm_params")


class EffectiveSINR(Block):
    """Template for effective SINR computation across subcarriers and
    streams.

    Input sinr: [..., num_ofdm_symbols, num_subcarriers, num_ut,
    num_streams_per_ut] (0 marks an unused stream). Output: [...,
    num_ut] or, with per_stream=True, [..., num_ut, streams]."""

    def calibrate(self):
        """Optional calibration hook"""

    @abstractmethod
    def forward(self, sinr, mcs_index=None, mcs_table_index=None,
                mcs_category=None, per_stream=False, **kwargs):
        ...


class EESM(EffectiveSINR):
    """Exponential effective SINR mapping (EESM):
    sinr_eff = -beta * log(mean(exp(-sinr / beta))) over the used
    resources, beta from a per-(table, MCS) calibration table."""

    def __init__(self, load_beta_table_from="default",
                 sinr_eff_min_db=-30, sinr_eff_max_db=30,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        # the limits in the real dtype, as the JAX package rounds them
        self._sinr_eff_min = float(np.power(
            self.np_rdtype(10.0), self.np_rdtype(sinr_eff_min_db) / 10))
        self._sinr_eff_max = float(np.power(
            self.np_rdtype(10.0), self.np_rdtype(sinr_eff_max_db) / 10))
        self._beta_table = None
        if load_beta_table_from == "default":
            self.beta_table_filenames = str(_ESM_DIR
                                            / "eesm_beta_table.json")
        else:
            self.beta_table_filenames = load_beta_table_from

    @property
    def beta_table(self):
        """dict: beta_table['index'][mcs_table_index] -> [beta per
        MCS]"""
        return self._beta_table

    @property
    def beta_tensor(self):
        """[n_tables, n_mcs] beta table on the block's device"""
        return self._beta_tensor

    @property
    def beta_table_filenames(self):
        return self._beta_table_filenames

    @beta_table_filenames.setter
    def beta_table_filenames(self, value):
        self._beta_table_filenames = to_list(value)
        self._beta_table = DeepUpdateDict({})
        for f in self._beta_table_filenames:
            with open(f, encoding="utf-8") as fh:
                subtable = json.load(fh, object_hook=dict_keys_to_int)
            self._beta_table.deep_update(subtable)
        if self._beta_table == {}:
            raise ValueError("No EESM beta parameter table found.")
        self.validate_beta_table()

        table_idx_vec = list(self._beta_table["index"].keys())
        n_mcs = max(len(self._beta_table["index"][t])
                    for t in table_idx_vec)
        beta = np.zeros([max(table_idx_vec), n_mcs], self.np_rdtype)
        for t in table_idx_vec:
            v = self._beta_table["index"][t]
            beta[t - 1, :len(v)] = v
        self.register_buffer("_beta_tensor", torch.as_tensor(
            beta, device=self.device), persistent=False)

    def validate_beta_table(self):
        """Validates the structure of ``beta_table``."""
        if not isinstance(self._beta_table, dict):
            raise ValueError("Must be a dictionary")
        if "index" not in self._beta_table:
            raise ValueError("Key must be 'index'")
        for t, v in self._beta_table["index"].items():
            if not isinstance(v, list):
                raise ValueError(
                    f"beta_table['index'][{t}] must be a list")
        return True

    def forward(self, sinr, mcs_index, mcs_table_index=1,
                mcs_category=None, per_stream=False, **kwargs):
        sinr = sinr.to(self.rdtype)
        num_ut = sinr.shape[-2]
        batch_dims = tuple(sinr.shape[:-4])
        nb = len(batch_dims)
        dev = sinr.device
        mcs_index = scalar_to_shaped_tensor(
            mcs_index, torch.int32, batch_dims + (num_ut,), device=dev)
        mcs_table_index = scalar_to_shaped_tensor(
            mcs_table_index, torch.int32, batch_dims + (num_ut,),
            device=dev)

        # [..., ut, streams, sym, sc]
        sinr = sinr.permute(tuple(range(nb)) + (nb + 2, nb + 3, nb, nb + 1))
        axis = (-2, -1) if per_stream else (-3, -2, -1)

        used = sinr > 0
        num_used = torch.sum(used.to(self.rdtype), dim=axis)
        mcs_index = torch.clamp_min(mcs_index, 0)

        idx = torch.stack([mcs_table_index - 1, mcs_index], dim=-1)
        beta = gather_from_batched_indices(self._beta_tensor, idx)

        beta_e = expand_to_rank(beta, sinr.dim(), axis=-1)
        zero = torch.zeros((), dtype=self.rdtype, device=dev)
        # XLA flushes subnormal floats to zero (on the CPU and the TPU):
        # so here, so that a mean that underflows saturates the
        # effective SINR at its maximum as in the JAX package
        tiny = torch.finfo(self.rdtype).tiny
        sinr_exp = torch.exp(-sinr / beta_e)
        sinr_exp = torch.where(used & (sinr_exp >= tiny), sinr_exp, zero)

        num_used_safe = torch.clamp_min(num_used, 1.)
        mean_exp = torch.sum(sinr_exp, dim=axis) / num_used_safe
        mean_exp = torch.where(mean_exp >= tiny, mean_exp, zero)
        log_mean = torch.log(torch.clamp_min(
            mean_exp, 1e-38 if 1e-38 >= tiny else 0.))
        beta_e2 = expand_to_rank(beta, log_mean.dim(), axis=-1)
        sinr_eff = -beta_e2 * log_mean

        sinr_eff = torch.where(num_used > 0, sinr_eff, zero)
        sinr_eff = torch.clamp_max(sinr_eff, self._sinr_eff_max)
        return torch.where(
            (sinr_eff > 0) & (sinr_eff < self._sinr_eff_min),
            zero + self._sinr_eff_min, sinr_eff)
