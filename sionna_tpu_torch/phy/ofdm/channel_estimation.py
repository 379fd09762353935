"""OFDM channel estimation (counterpart of
``sionna_tpu/phy/ofdm/channel_estimation.py``; the port has LS
estimation with nearest-neighbour interpolation).

Pilot extraction and nearest-neighbour interpolation are static gathers
whose indices are computed once on the host. The JAX package's run and
one-hot variants of the same gathers are TPU layout work and are left
out; linear and LMMSE interpolation are not ported yet (ROADMAP.md).
"""

import numpy as np
import torch

from ..block import Block, Object
from ..utils.tensors import expand_to_rank
from .resource_grid import ResourceGrid, RemoveNulledSubcarriers

__all__ = ["BaseChannelEstimator", "BaseChannelInterpolator",
           "LSChannelEstimator", "NearestNeighborInterpolator"]


class BaseChannelInterpolator(Object):
    """Abstract OFDM channel interpolator."""

    def __call__(self, h_hat, err_var):
        raise NotImplementedError


class NearestNeighborInterpolator(BaseChannelInterpolator):
    """Assigns each RE the channel estimate of the nearest pilot
    (Manhattan distance)."""

    def __init__(self, pilot_pattern):
        super().__init__()
        if pilot_pattern.num_pilot_symbols == 0:
            raise ValueError("The pilot pattern cannot be empty")
        mask = np.array(pilot_pattern.mask)
        mask_shape = mask.shape
        mask_flat = mask.reshape([-1] + list(mask_shape[-2:]))
        pilots = np.asarray(pilot_pattern.pilots)
        pilots = pilots.reshape([-1, pilots.shape[-1]])
        if np.max(np.sum(np.abs(pilots) == 0, -1)) >= pilots.shape[-1]:
            raise ValueError("At least one pilot must be non-zero")

        gather_ind = np.zeros_like(mask_flat, dtype=np.int64)
        for a in range(gather_ind.shape[0]):
            i_p, j_p = np.where(mask_flat[a])
            for i in range(mask_shape[-2]):
                for j in range(mask_shape[-1]):
                    d = np.abs(i - i_p) + np.abs(j - j_p)
                    d = d.astype(np.float64)
                    d[np.abs(pilots[a]) == 0] = np.sum(mask_shape[-2:])
                    gather_ind[a, i, j] = int(np.argmin(d))
        self._gather_ind = gather_ind.reshape(mask_shape)
        # flat index into [tx * s * P] per (tx, s, sym * eff)
        t, s, n_sym, n_eff = mask_shape
        n_p = pilots.shape[-1]
        base = (np.arange(t * s) * n_p).reshape(t, s, 1)
        self._flat_ind = base + self._gather_ind.reshape(t, s, -1)
        self._flat_cache = {}

    def _gather(self, x):
        """x: [..., tx, s, P] (tx/s may be broadcast) ->
        [..., tx, s, sym, eff]."""
        t, s, n_sym, n_eff = self._gather_ind.shape
        if x.device not in self._flat_cache:
            self._flat_cache[x.device] = torch.as_tensor(self._flat_ind,
                                                         device=x.device)
        lead = tuple(x.shape[:-3])
        x = x.expand(lead + (t, s, x.shape[-1])).reshape(lead + (-1,))
        out = x[..., self._flat_cache[x.device]]
        return out.reshape(lead + (t, s, n_sym, n_eff))

    def __call__(self, h_hat, err_var):
        h_hat = torch.as_tensor(h_hat)
        # err_var is gathered at its own (batch-less for a scalar noise
        # variance) shape and broadcast only at the end
        err_var = torch.as_tensor(err_var)
        err_var = err_var.expand(tuple(err_var.shape[:-3])
                                 + tuple(h_hat.shape[-3:-1])
                                 + tuple(err_var.shape[-1:]))
        h_out = self._gather(h_hat)
        ev_out = self._gather(err_var).expand(h_out.shape)
        return h_out, ev_out


class BaseChannelEstimator(Block):
    """Extracts pilots, estimates at pilot positions, interpolates."""

    def __init__(self, resource_grid, interpolation_type="nn",
                 interpolator=None, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(resource_grid, ResourceGrid):
            raise TypeError(
                "You must provide a valid instance of ResourceGrid.")
        self._resource_grid = resource_grid
        self._pilot_pattern = resource_grid.pilot_pattern
        self._remove_nulled_scs = RemoveNulledSubcarriers(
            resource_grid, precision=self.precision, device=device)
        if interpolation_type not in ("nn", "lin", "lin_time_avg", None):
            raise ValueError("Unsupported `interpolation_type`")
        self._interpolation_type = interpolation_type
        if interpolator is not None:
            self._interpolator = interpolator
        elif interpolation_type == "nn":
            self._interpolator = NearestNeighborInterpolator(
                self._pilot_pattern)
        elif interpolation_type in ("lin", "lin_time_avg"):
            raise NotImplementedError(
                f"interpolation_type='{interpolation_type}': the linear "
                "interpolator is not ported yet (ROADMAP.md, queue 1 "
                "item 10)")
        else:
            raise ValueError("You must provide an interpolator")

        # static pilot-position gather indices per (tx, stream):
        # positions in the flattened [sym * eff] grid, row-major
        mask = np.array(self._pilot_pattern.mask)
        num_pilots = self._pilot_pattern.num_pilot_symbols
        mask_flat = mask.reshape(mask.shape[:-2] + (-1,))
        pilot_ind = np.zeros(mask.shape[:2] + (num_pilots,), np.int64)
        for t in range(mask.shape[0]):
            for s in range(mask.shape[1]):
                pilot_ind[t, s] = np.where(mask_flat[t, s])[0]
        self.register_buffer("_pilot_ind",
                             torch.as_tensor(pilot_ind, device=self.device),
                             persistent=False)

    def estimate_at_pilot_locations(self, y_pilots, no):
        raise NotImplementedError

    def forward(self, y, no):
        y = torch.as_tensor(y).to(self.cdtype)
        y_eff = self._remove_nulled_scs(y)  # [b, rx, rxa, sym, eff]
        y_flat = y_eff.reshape(y_eff.shape[:-2] + (-1,))
        # gather pilots: [b, rx, rxa, tx, s, num_pilots]
        y_pilots = y_flat[..., self._pilot_ind.to(y.device)]
        no = torch.as_tensor(no).to(device=y.device, dtype=self.rdtype)
        h_hat, err_var = self.estimate_at_pilot_locations(y_pilots, no)
        # the NN interpolator gathers err_var at its natural (batch-less)
        # shape; other interpolators get the fully broadcast layout
        if not isinstance(self._interpolator, NearestNeighborInterpolator):
            err_var = torch.as_tensor(err_var).expand(h_hat.shape)
        return self._interpolator(h_hat, err_var)


class LSChannelEstimator(BaseChannelEstimator):
    """LS estimation at pilots + interpolation."""

    def __init__(self, resource_grid, interpolation_type="nn",
                 interpolator=None, precision=None, device=None):
        super().__init__(resource_grid, interpolation_type, interpolator,
                         precision=precision, device=device)
        self.register_buffer(
            "_pilots", torch.as_tensor(self._pilot_pattern.pilots,
                                       device=self.device).to(self.cdtype),
            persistent=False)

    def estimate_at_pilot_locations(self, y_pilots, no):
        pilots = self._pilots.to(y_pilots.device)
        zero = torch.abs(pilots) == 0
        denom = torch.where(zero, torch.ones_like(pilots), pilots)
        h_ls = torch.where(zero, torch.zeros_like(y_pilots),
                           y_pilots / denom)
        no_b = expand_to_rank(no, h_ls.dim(), -1)
        p2 = torch.abs(pilots) ** 2
        # err_var stays unbroadcast (batch-independent for a scalar no)
        err_var = torch.where(p2 == 0, torch.zeros_like(p2),
                              no_b / torch.clamp_min(p2, 1e-30))
        return h_ls, err_var
