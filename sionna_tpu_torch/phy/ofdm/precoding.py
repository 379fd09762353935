"""OFDM transmit precoding (counterpart of
``sionna_tpu/phy/ofdm/precoding.py``): RZF precoding of resource grids
and the effective channels after RZF, conjugate-beamforming and
identity precoding. None of these blocks has trainable parameters."""

from abc import abstractmethod

import torch

from ..block import Block
from ..mimo import (StreamManagement, cbf_precoding_matrix, rzf_precoder,
                    rzf_precoding_matrix)
from ..utils.linalg import _matmul
from ..utils.tensors import expand_to_rank
from .resource_grid import RemoveNulledSubcarriers, ResourceGrid

__all__ = ["RZFPrecoder", "PrecodedChannel", "RZFPrecodedChannel",
           "CBFPrecodedChannel", "EyePrecodedChannel"]


def _gather_desired_channels(h_hat, stream_management):
    """[b, rx, rxa, tx, txa, sym, sc] -> the channels of each TX to the
    streams it serves [b, tx, sym, sc, num_streams_per_tx, num_tx_ant]."""
    ind = torch.as_tensor(stream_management.precoding_ind,
                          device=h_hat.device)  # [tx, rx_per_tx]
    # [tx, rx, rxa, txa, sym, sc, b] -> [tx, rx_per_tx, rxa, ...]
    h_pc = h_hat.permute(3, 1, 2, 4, 5, 6, 0)
    h_pc = h_pc[torch.arange(ind.shape[0], device=h_hat.device)[:, None],
                ind]
    h_pc = h_pc.reshape((h_pc.shape[0], -1) + h_pc.shape[3:])
    return h_pc.permute(5, 0, 3, 4, 1, 2)


def _effective_channel(h, g, remove_nulled_scs, cdtype):
    """h: [b, rx, rxa, tx, txa, sym, sc]; g: [b, tx, sym, sc, txa,
    streams] -> h_eff: [b, rx, rxa, tx, streams, sym, n_eff_sc]."""
    h_t = h.permute(0, 1, 3, 5, 6, 2, 4).to(cdtype)
    h_eff = _matmul(h_t, g[:, None])
    return remove_nulled_scs(h_eff.permute(0, 1, 5, 2, 6, 3, 4))


class RZFPrecoder(Block):
    """Regularized zero-forcing precoding of OFDM resource grids.

    Input: x [b, tx, streams_per_tx, sym, fft], h [b, rx, rxa, tx, txa,
    sym, fft], alpha (default 0: zero forcing). Output: x_precoded
    [b, tx, txa, sym, fft], and the effective channel if
    ``return_effective_channel``.
    """

    def __init__(self, resource_grid, stream_management,
                 return_effective_channel=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        assert isinstance(resource_grid, ResourceGrid)
        assert isinstance(stream_management, StreamManagement)
        self._resource_grid = resource_grid
        self._stream_management = stream_management
        self._return_effective_channel = bool(return_effective_channel)
        self._remove_nulled_scs = RemoveNulledSubcarriers(
            resource_grid, device=device)

    def forward(self, x, h, alpha=0.):
        x_precoded = x.permute(0, 1, 3, 4, 2).to(self.cdtype)
        h = h.to(self.cdtype)
        h_pc_desired = _gather_desired_channels(h, self._stream_management)
        alpha = expand_to_rank(torch.as_tensor(alpha, device=h.device).to(
            self.rdtype), 4, axis=0)
        x_precoded, g = rzf_precoder(x_precoded, h_pc_desired, alpha=alpha,
                                     return_precoding_matrices=True,
                                     precision=self.precision)
        x_precoded = x_precoded.permute(0, 1, 4, 2, 3)
        if self._return_effective_channel:
            return x_precoded, _effective_channel(
                h, g, self._remove_nulled_scs, self.cdtype)
        return x_precoded


class PrecodedChannel(Block):
    """Abstract base computing the effective channel after precoding;
    its output feeds
    :class:`~sionna_tpu_torch.phy.ofdm.PostEqualizationSINR`."""

    def __init__(self, resource_grid, stream_management, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        assert isinstance(resource_grid, ResourceGrid)
        assert isinstance(stream_management, StreamManagement)
        self._resource_grid = resource_grid
        self._stream_management = stream_management
        self._remove_nulled_scs = RemoveNulledSubcarriers(
            resource_grid, device=device)

    def get_desired_channels(self, h_hat):
        """[b, rx, rxa, tx, txa, sym, fft] -> [b, tx, sym, fft,
        streams_per_tx, txa]."""
        h_pc_desired = _gather_desired_channels(
            torch.as_tensor(h_hat).to(self.cdtype), self._stream_management)
        if h_pc_desired.shape[-2] != \
                self._stream_management.num_streams_per_tx:
            raise ValueError(
                "The required number of streams per transmitter does "
                "not match the channel dimensions")
        return h_pc_desired

    def compute_effective_channel(self, h, g):
        """The effective channel after precoding with g."""
        return _effective_channel(torch.as_tensor(h).to(self.cdtype), g,
                                  self._remove_nulled_scs, self.cdtype)

    def apply_tx_power(self, g, tx_power):
        """Scales the precoding columns by the per-stream sqrt power."""
        tx_power = expand_to_rank(torch.as_tensor(
            tx_power, device=g.device).to(self.rdtype), 6, axis=-1)
        # [b, tx, sym, fft, 1 (txa), streams]
        tx_power = tx_power.permute(0, 1, 3, 4, 5, 2)
        return torch.sqrt(tx_power).to(self.cdtype) * g

    @abstractmethod
    def forward(self, h, tx_power, h_hat=None, **kwargs):
        ...


class RZFPrecodedChannel(PrecodedChannel):
    """Effective channel after RZF precoding."""

    def forward(self, h, tx_power, h_hat=None, alpha=0.):
        if h_hat is None:
            h_hat = h
        h_pc_desired = self.get_desired_channels(h_hat)
        alpha = expand_to_rank(torch.as_tensor(
            alpha, device=h_pc_desired.device).to(self.rdtype), 4, axis=-1)
        g = rzf_precoding_matrix(h_pc_desired, alpha,
                                 precision=self.precision)
        g = self.apply_tx_power(g, tx_power)
        return self.compute_effective_channel(h, g)


class CBFPrecodedChannel(PrecodedChannel):
    """Effective channel after conjugate beamforming."""

    def forward(self, h, tx_power, h_hat=None):
        if h_hat is None:
            h_hat = h
        g = cbf_precoding_matrix(self.get_desired_channels(h_hat),
                                 precision=self.precision)
        g = self.apply_tx_power(g, tx_power)
        return self.compute_effective_channel(h, g)


class EyePrecodedChannel(PrecodedChannel):
    """Effective channel of identity precoding (power allocation
    only)."""

    def forward(self, h, tx_power):
        h = torch.as_tensor(h).to(self.cdtype)
        b, _, _, num_tx, num_tx_ant, num_sym, fft = h.shape
        g = torch.eye(num_tx_ant, dtype=self.cdtype, device=h.device).expand(
            b, num_tx, num_sym, fft, num_tx_ant, num_tx_ant)
        g = self.apply_tx_power(g, tx_power)
        return self.compute_effective_channel(h, g)
