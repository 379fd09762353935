"""PUSCH DMRS-aware LS channel estimation with CDM despreading
(counterpart of ``sionna_tpu/phy/nr/pusch_channel_estimation.py``)."""

import numpy as np
import torch

from ..ofdm.channel_estimation import BaseChannelEstimator
from ..utils.tensors import expand_to_rank, split_dim

__all__ = ["PUSCHLSChannelEstimator"]


class PUSCHLSChannelEstimator(BaseChannelEstimator):
    """LS estimation at DMRS positions with time/frequency averaging
    across CDM groups.

    A DMRS pilot pattern holds zeros where another CDM group sends: the
    LS estimate is 0 there, and its division is made by 1, so that no
    inf or NaN arises on the branch ``where`` does not take. The error
    variance keeps the natural (batch-less for a scalar ``no``) shape of
    :class:`~sionna_tpu_torch.phy.ofdm.LSChannelEstimator`'s, which the
    interpolators broadcast.
    """

    def __init__(self, resource_grid, dmrs_length,
                 dmrs_additional_position, num_cdm_groups_without_data,
                 interpolation_type="nn", interpolator=None,
                 precision=None, device=None):
        super().__init__(resource_grid, interpolation_type,
                         interpolator, precision=precision, device=device)
        self._dmrs_length = int(dmrs_length)
        self._dmrs_additional_position = int(dmrs_additional_position)
        self._num_cdm_groups_without_data = int(
            num_cdm_groups_without_data)
        self._num_dmrs_syms = self._dmrs_length \
            * (self._dmrs_additional_position + 1)
        pilots = np.asarray(self._pilot_pattern.pilots)
        self._num_pilots_per_dmrs_sym = int(
            pilots.shape[-1] / self._num_dmrs_syms)
        self.register_buffer(
            "_pilots", torch.as_tensor(pilots, device=self.device).to(
                self.cdtype), persistent=False)

    def estimate_at_pilot_locations(self, y_pilots, no):
        pilots = self._pilots.to(y_pilots.device)
        zero = torch.abs(pilots) == 0
        denom = torch.where(zero, torch.ones_like(pilots), pilots)
        h_ls = torch.where(zero, torch.zeros_like(y_pilots),
                           y_pilots / denom)
        h_ls_shape = h_ls.shape
        no_b = expand_to_rank(no, h_ls.dim(), -1)
        p2 = torch.abs(pilots) ** 2
        err_var = torch.where(p2 == 0, torch.zeros_like(p2),
                              no_b / torch.clamp_min(p2, 1e-30))

        h_hat = h_ls
        # time-averaging across double-symbol DMRS
        if self._dmrs_length == 2:
            h_hat = split_dim(h_hat, [self._num_dmrs_syms,
                                      self._num_pilots_per_dmrs_sym], 5)
            h_hat = (h_hat[..., 0::2, :] + h_hat[..., 1::2, :]) / 2
            h_hat = torch.repeat_interleave(h_hat, 2, dim=-2)
            h_hat = h_hat.reshape(h_ls_shape)
            err_var = err_var / 2

        # frequency-averaging across CDM groups
        n = 2 * self._num_cdm_groups_without_data
        k = h_hat.shape[-1] // n
        h_hat = split_dim(h_hat, [k, n], 5)
        cond = torch.abs(h_hat) > 0
        h_hat = torch.sum(h_hat, dim=-1, keepdim=True) / 2
        h_hat = h_hat.expand(h_hat.shape[:-1] + (n,))
        h_hat = torch.where(cond, h_hat, torch.zeros_like(h_hat))
        h_hat = h_hat.reshape(h_ls_shape)
        err_var = err_var / 2
        return h_hat, err_var
