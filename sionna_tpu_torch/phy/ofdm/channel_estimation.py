"""OFDM channel estimation (counterpart of
``sionna_tpu/phy/ofdm/channel_estimation.py``): LS estimation with
nearest-neighbour, linear or LMMSE interpolation.

Pilot extraction and nearest-neighbour interpolation are static gathers
whose indices are computed once on the host; linear interpolation is a
dense ``[RE, pilots]`` operator built on the host and applied as one
matrix product. The LMMSE interpolators solve one system per row (and
per batch element, since the error variances come with the call) with
batched ``torch.linalg.solve``, in the precision of the covariance
matrices given (the TDL helpers return complex128, so they run in f64 as
in the JAX package). The JAX package's run and one-hot variants of the
gathers are TPU layout work and are left out.
"""

import json
from pathlib import Path

import numpy as np
import torch

from ..block import Block, Object
from ..constants import SPEED_OF_LIGHT
from ..utils.tensors import expand_to_rank
from .resource_grid import ResourceGrid, RemoveNulledSubcarriers

__all__ = ["BaseChannelEstimator", "BaseChannelInterpolator",
           "LSChannelEstimator", "NearestNeighborInterpolator",
           "LinearInterpolator", "LMMSEInterpolator",
           "LMMSEInterpolator1D", "SpatialChannelFilter",
           "tdl_freq_cov_mat", "tdl_time_cov_mat"]

# The TR 38.901 TDL tables, read where the JAX package keeps them
_MODELS_DIR = (Path(__file__).resolve().parents[3] / "sionna_tpu" / "phy"
               / "channel" / "tr38901" / "models")


def _on(cache, device, arrays):
    """``arrays`` (a dict of NumPy arrays) as tensors on ``device``,
    cached in ``cache``."""
    if device not in cache:
        cache[device] = {k: torch.as_tensor(v, device=device)
                         for k, v in arrays.items()}
    return cache[device]


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


class LinearInterpolator(BaseChannelInterpolator):
    """Linear interpolation, first across subcarriers, then across OFDM
    symbols (or averaged over the pilot symbols with ``time_avg``), as
    one dense ``[tx, s, RE, P]`` operator built on the host and applied
    as one matrix product."""

    def __init__(self, pilot_pattern, time_avg=False):
        super().__init__()
        if pilot_pattern.num_pilot_symbols == 0:
            raise ValueError("The pilot pattern cannot be empty")
        mask = np.array(pilot_pattern.mask)
        num_sym, num_eff = mask.shape[-2:]
        mask_flat = mask.reshape([-1, num_sym, num_eff])
        pilots = np.asarray(pilot_pattern.pilots)
        pilots_flat = pilots.reshape([-1, pilots.shape[-1]])
        w = np.stack([self._build_operator(mask_flat[a], pilots_flat[a],
                                           num_sym, num_eff, time_avg)
                      for a in range(mask_flat.shape[0])])
        self._w = w.reshape(mask.shape[:-2]
                            + (num_sym * num_eff, pilots.shape[-1]))
        self._num_sym, self._num_eff = num_sym, num_eff
        self._w_cache = {}

    @staticmethod
    def _build_operator(mask, pilots, num_sym, num_eff, time_avg):
        """Dense [num_sym*num_eff, P] linear-interpolation operator;
        linear extrapolation from the two nearest pilots outside their
        span."""
        p_total = len(pilots)
        i_p, j_p = np.where(mask)  # row-major pilot coordinates
        valid = np.abs(pilots) != 0
        pilot_syms = np.unique(i_p[valid])

        def lerp(x, xs):
            """(left, right, weight of right) of x among sorted xs."""
            if x <= xs[0]:
                l, r = 0, 1
            elif x >= xs[-1]:
                l, r = len(xs) - 2, len(xs) - 1
            else:
                r = int(np.searchsorted(xs, x))
                if xs[r] == x:
                    return r, r, 0.
                l = r - 1
            return l, r, (x - xs[l]) / (xs[r] - xs[l])

        freq_ops = {}
        for si in pilot_syms:
            sel = np.where((i_p == si) & valid)[0]
            js = j_p[sel]
            order = np.argsort(js)
            js, sel = js[order], sel[order]
            op = np.zeros((num_eff, p_total))
            for j in range(num_eff):
                if len(js) == 1:
                    op[j, sel[0]] = 1
                    continue
                l, r, wgt = lerp(j, js)
                if l == r:
                    op[j, sel[r]] = 1
                else:
                    op[j, sel[l]] = 1 - wgt
                    op[j, sel[r]] = wgt
            freq_ops[si] = op

        w = np.zeros((num_sym, num_eff, p_total))
        if time_avg:
            w[:] = np.mean([freq_ops[si] for si in pilot_syms], axis=0)
        else:
            ps = np.asarray(sorted(pilot_syms))
            for t in range(num_sym):
                if len(ps) == 1:
                    w[t] = freq_ops[ps[0]]
                    continue
                l, r, wgt = lerp(t, ps)
                if l == r:
                    w[t] = freq_ops[ps[r]]
                else:
                    w[t] = (1 - wgt) * freq_ops[ps[l]] \
                        + wgt * freq_ops[ps[r]]
        return w.reshape(num_sym * num_eff, p_total)

    def _apply(self, x):
        # x: [b, rx, rxa, tx, s, P] -> [b, rx, rxa, tx, s, sym, eff]
        key = (x.device, x.dtype)
        if key not in self._w_cache:
            self._w_cache[key] = torch.as_tensor(self._w, device=x.device
                                                 ).to(x.dtype)
        out = torch.einsum("...tsp,tsrp->...tsr", x, self._w_cache[key])
        return out.reshape(out.shape[:-1] + (self._num_sym, self._num_eff))

    def __call__(self, h_hat, err_var):
        h_hat = torch.as_tensor(h_hat)
        # err_var (batch-less for a scalar noise variance) is
        # interpolated at its own shape and broadcast after
        err_var = torch.as_tensor(err_var)
        err_var = err_var.expand(tuple(err_var.shape[:-3])
                                 + tuple(h_hat.shape[-3:-1])
                                 + tuple(err_var.shape[-1:]))
        h_out = self._apply(h_hat)
        # error variances through the same (real) operator
        err_out = torch.clamp_min(self._apply(err_var.to(h_hat.dtype)).real,
                                  0.)
        return h_out, err_out.expand(h_out.shape)


class LMMSEInterpolator(BaseChannelInterpolator):
    """Ordered per-dimension LMMSE interpolation and smoothing.

    ``order`` names the 1D passes: ``"t-f"`` (time, then frequency),
    ``"f-t"``, or ``"t-f-s"`` (then spatial smoothing across the receive
    antennas). Each pass is an :class:`LMMSEInterpolator1D` (or a
    :class:`SpatialChannelFilter`) along its dimension; between passes
    the estimates are rescaled so that their variances match what the
    next pass expects. Time and frequency are mandatory; each dimension
    appears at most once.
    """

    def __init__(self, pilot_pattern, cov_mat_time, cov_mat_freq,
                 cov_mat_space=None, order="t-f"):
        super().__init__()
        steps = order.split("-")
        if not 2 <= len(steps) <= 3 or len(set(steps)) != len(steps) \
                or any(o not in ("t", "f", "s") for o in steps) \
                or "t" not in steps or "f" not in steps:
            raise ValueError(
                "order must name 't' and 'f' (and optionally 's') "
                "each at most once, e.g. 't-f', 'f-t', 't-f-s'")
        if "s" in steps and cov_mat_space is None:
            raise ValueError("cov_mat_space is required for spatial "
                             "smoothing ('s' in order)")
        self._order = steps

        mask = np.array(pilot_pattern.mask)
        pilots = np.asarray(pilot_pattern.pilots)
        num_tx, num_st, num_sym, num_eff = mask.shape
        self._num_sym, self._num_eff = num_sym, num_eff

        # Pilot mask over the grid: 0 = data, 1 = pilot, 2 = masked
        # (zero-power pilot); per-(tx, st) scatter maps from the pilot
        # vector into the flattened grid
        pilot_mask = np.zeros(mask.shape, np.int64)
        self._host = {}
        for tx in range(num_tx):
            for st in range(num_st):
                pos = np.argwhere(mask[tx, st])  # row-major
                nonzero = np.abs(pilots[tx, st]) > 0.
                pilot_mask[tx, st, pos[:, 0], pos[:, 1]] = \
                    np.where(nonzero, 1, 2)
                flat = pos[:, 0] * num_eff + pos[:, 1]
                self._host[f"grid{tx},{st}"] = flat[nonzero]
                self._host[f"pilot{tx},{st}"] = np.where(nonzero)[0]

        # One 1D pass per order entry, built against the pilot mask as
        # it evolves (a pass fills every row it touches)
        self._passes = []
        for i, o in enumerate(steps):
            last = i == len(steps) - 1
            if o == "f":
                interp = LMMSEInterpolator1D(pilot_mask, cov_mat_freq,
                                             last_step=last)
                filled = np.any(pilot_mask == 1, axis=-1, keepdims=True)
                pilot_mask = np.where(filled, 1, pilot_mask)
            elif o == "t":
                interp = LMMSEInterpolator1D(
                    np.swapaxes(pilot_mask, -1, -2), cov_mat_time,
                    last_step=last)
                filled = np.any(pilot_mask == 1, axis=-2, keepdims=True)
                pilot_mask = np.where(filled, 1, pilot_mask)
            else:
                interp = SpatialChannelFilter(cov_mat_space, last_step=last)
            self._passes.append((o, interp))
            self._host[f"mask{i}"] = pilot_mask == 1
        self._cache = {}

    def __call__(self, h_hat, err_var):
        h_hat = torch.as_tensor(h_hat)
        err_var = torch.as_tensor(err_var).to(
            device=h_hat.device, dtype=h_hat.real.dtype).expand(h_hat.shape)
        lead = tuple(h_hat.shape[:-3])  # [batch, num_rx, num_rx_ant]
        num_tx, num_st = h_hat.shape[-3], h_hat.shape[-2]

        # Scatter the pilot estimates onto the full resource grid
        grid_shape = lead + (num_tx, num_st, self._num_sym * self._num_eff)
        h = torch.zeros(grid_shape, dtype=h_hat.dtype, device=h_hat.device)
        e = torch.zeros(grid_shape, dtype=err_var.dtype,
                        device=h_hat.device)
        c = _on(self._cache, h_hat.device, self._host)
        for tx in range(num_tx):
            for st in range(num_st):
                gi, pi = c[f"grid{tx},{st}"], c[f"pilot{tx},{st}"]
                h[..., tx, st, gi] = h_hat[..., tx, st, pi]
                e[..., tx, st, gi] = err_var[..., tx, st, pi]
        h = h.reshape(grid_shape[:-1] + (self._num_sym, self._num_eff))
        e = e.reshape(grid_shape[:-1] + (self._num_sym, self._num_eff))

        for i, (o, interp) in enumerate(self._passes):
            mask = c[f"mask{i}"]
            if o == "f":
                h, e = interp(h, e)
                e = e * mask.to(e.dtype)
            elif o == "t":
                h, e = interp(h.transpose(-1, -2), e.transpose(-1, -2))
                h, e = h.transpose(-1, -2), e.transpose(-1, -2)
                e = e * mask.to(e.dtype)
            else:
                # smooth across receive antennas ([..., rxa, tx, st, sym,
                # sc] -> rxa last)
                h, e = interp(torch.movedim(h, -5, -1),
                              torch.movedim(e, -5, -1))
                h, e = torch.movedim(h, -1, -5), torch.movedim(e, -1, -5)
        return h, e


def _load_tdl_pdp(model):
    """(delays, linear mean powers, LoS flag) of a TDL model, from the
    TR 38.901 JSON tables."""
    if model not in ("A", "B", "C", "D", "E"):
        raise ValueError("Invalid TDL model")
    with open(_MODELS_DIR / f"TDL-{model}.json") as f:
        params = json.load(f)
    delays = np.array(params["delays"], np.float64)
    mean_powers = 10.0 ** (np.array(params["powers"], np.float64) / 10.0)
    return delays, mean_powers, bool(params["los"])


def tdl_freq_cov_mat(model, subcarrier_spacing, fft_size, delay_spread,
                     precision=None):
    """Frequency covariance matrix of a TDL channel model,
    R[f1, f2] = sum_p P_p exp(-j 2 pi (f1 - f2) scs tau_p) (host NumPy,
    [fft_size, fft_size] complex128)."""
    delays, mean_powers, los = _load_tdl_pdp(model)
    delays = delays * delay_spread
    if los:
        # merge the specular and the diffuse part of the first path
        # (both at delay 0)
        mean_powers[0] = mean_powers[0] + mean_powers[1]
        mean_powers = np.concatenate([mean_powers[:1], mean_powers[2:]])
        delays = delays[1:]
    mean_powers = mean_powers / np.sum(mean_powers)
    n = np.arange(fft_size)
    p = np.exp(1j * (-2. * np.pi * subcarrier_spacing * n)[None]
               * delays[:, None])  # [P, F]
    return np.einsum("p,pi,pj->ij", mean_powers, p, np.conj(p))


def tdl_time_cov_mat(model, speed, carrier_frequency, ofdm_symbol_duration,
                     num_ofdm_symbols, los_angle_of_arrival=np.pi / 4.,
                     precision=None):
    """Time covariance matrix of a TDL channel model: a Jakes J0 term
    weighted by the NLoS power plus, for LoS models, a complex
    exponential at the LoS Doppler (host NumPy,
    [num_ofdm_symbols, num_ofdm_symbols] complex128)."""
    from scipy.special import jv
    doppler_spread = 2. * np.pi * speed / SPEED_OF_LIGHT * carrier_frequency
    _, mean_powers, los = _load_tdl_pdp(model)
    mean_powers = mean_powers / np.sum(mean_powers)
    if los:
        los_power = mean_powers[0]
        nlos_power = np.sum(mean_powers[1:])
    else:
        los_power = 0.
        nlos_power = np.sum(mean_powers)
    t = np.arange(num_ofdm_symbols)
    exp = doppler_spread * ofdm_symbol_duration * (t[:, None] - t[None, :])
    cov = jv(0.0, exp) * nlos_power + 0j
    if los:
        cov = cov + los_power * np.exp(
            1j * exp * np.cos(los_angle_of_arrival))
    return cov


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
        elif interpolation_type == "lin":
            self._interpolator = LinearInterpolator(self._pilot_pattern)
        elif interpolation_type == "lin_time_avg":
            self._interpolator = LinearInterpolator(self._pilot_pattern,
                                                    time_avg=True)
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
        # the NN and linear interpolators take err_var at its natural
        # (batch-less) shape; other interpolators get the fully broadcast
        # layout
        if not isinstance(self._interpolator, (NearestNeighborInterpolator,
                                               LinearInterpolator)):
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


class LMMSEInterpolator1D(Object):
    """LMMSE interpolation along the inner dimension of a 2D grid.

    The interpolation matrix of row n, A_n = R Pi_n (Pi_n^T R Pi_n +
    Sigma_n)^{-1} Pi_n^T, depends on the call's error variances, so it
    is solved at each call: one batched ``torch.linalg.solve`` over all
    rows and batch elements, with the pilot index maps padded to the
    largest row.

    pilot_mask: [num_tx, num_streams_per_tx, N, M] with 0 = data, 1 =
    pilot, 2 = unused. cov_mat: [M, M]; its dtype (complex64 or
    complex128) sets the precision. Inputs h_hat, err_var: [batch,
    num_rx, num_rx_ant, num_tx, num_streams_per_tx, N, M].
    """

    def __init__(self, pilot_mask, cov_mat, last_step=True):
        cov_mat = np.asarray(cov_mat)
        super().__init__(precision="single" if cov_mat.dtype == np.complex64
                         else "double")
        r = cov_mat.astype(self.np_cdtype)
        self._last_step = bool(last_step)

        pilot_mask = np.asarray(pilot_mask)
        num_tx, num_st, n_outer, _ = pilot_mask.shape
        max_k = max(1, int(np.max(np.sum(pilot_mask == 1, axis=-1))))
        idx = np.zeros((num_tx, num_st, n_outer, max_k), np.int64)
        valid = np.zeros((num_tx, num_st, n_outer, max_k), self.np_rdtype)
        for tx in range(num_tx):
            for st in range(num_st):
                for n in range(n_outer):
                    p = np.where(pilot_mask[tx, st, n] == 1)[0]
                    idx[tx, st, n, :len(p)] = p
                    valid[tx, st, n, :len(p)] = 1.
        # R restricted to the pilots: rp [t,s,N,M,K] (R[m, idx_k]),
        # rpp [t,s,N,K,K] (R[idx_k, idx_l], identity on padding), r_pm
        # [t,s,N,M,K] (R[idx_k, m])
        valid_c = valid.astype(self.np_cdtype)
        rows = r[idx]  # [t,s,N,K,M]
        pair = valid[..., :, None] * valid[..., None, :]
        rpp = r[idx[..., :, None], idx[..., None, :]] * pair \
            + (1. - pair) * np.eye(max_k)
        self._host = {
            "idx": idx, "valid": valid, "valid_c": valid_c,
            "rp": np.moveaxis(r[:, idx], 0, -2) * valid_c[..., None, :],
            "rpp": rpp.astype(self.np_cdtype),
            "r_pm": np.swapaxes(rows, -1, -2),
            "diag_r": np.real(np.diagonal(r)).astype(self.np_rdtype),
            "has_pilot": np.sum(valid, axis=-1)[..., None] > 0}
        self._cache = {}

    def __call__(self, h_hat, err_var):
        h_hat = torch.as_tensor(h_hat).to(self.cdtype)
        c = _on(self._cache, h_hat.device, self._host)
        err_var = torch.as_tensor(err_var).to(
            device=h_hat.device, dtype=self.rdtype).expand(h_hat.shape)
        err_var_old = err_var
        idx, valid, valid_c = c["idx"], c["valid"], c["valid_c"]
        k = idx.shape[-1]

        # error variances at the pilots (regularized)
        err_p = torch.gather(err_var, -1,
                             idx.expand(err_var.shape[:-1] + (k,)))
        err_p = torch.clamp_min(err_p, 1e-6) * valid
        a_mat = c["rpp"] + torch.diag_embed(err_p.to(self.cdtype))

        # A = Rp (Rpp + Sigma)^{-1} per row: one batched solve
        rp = c["rp"].expand(err_p.shape[:-1] + c["rp"].shape[-2:])
        a = torch.linalg.solve(a_mat.transpose(-2, -1),
                               rp.transpose(-2, -1)).transpose(-2, -1)
        a = a * valid_c[..., None, :]

        # interpolated estimates
        h_p = torch.gather(h_hat, -1, idx.expand(h_hat.shape[:-1] + (k,)))
        h_out = torch.matmul(a, (h_p * valid_c)[..., None])[..., 0]

        # error variances: diag(R) - Re{sum_k A[m,k] R[idx_k, m]}
        err_out = torch.clamp_min(
            c["diag_r"] - torch.sum(a * c["r_pm"], dim=-1).real, 0.)

        # rows without pilots pass through
        sel = c["has_pilot"]
        h_out = torch.where(sel, h_out, h_hat)
        err_out = torch.where(sel, err_out, err_var_old)

        if not self._last_step:
            # scale so that the next step sees the expected variance
            var1 = torch.sum(torch.matmul(a, c["rpp"]) * torch.conj(a),
                             dim=-1).real
            var2 = torch.sum(torch.abs(a) ** 2 * err_p[..., None, :],
                             dim=-1)
            h_hat_var = var1 + var2
            h_var = c["diag_r"]
            denom = h_hat_var + h_var - err_out
            s = torch.where(torch.abs(denom) > 1e-12, 2. * h_var / denom,
                            torch.zeros_like(denom))
            h_out = torch.where(sel, s.to(self.cdtype) * h_out, h_out)
            err_new = s * (s - 1.) * h_hat_var + (1. - s) * h_var \
                + s * err_out
            err_out = torch.where(sel, torch.clamp_min(err_new, 0.),
                                  err_out)
        return h_out, err_out


class SpatialChannelFilter(Object):
    """LMMSE smoothing across the receive antennas: A = R (R +
    diag(err_var))^{-1} per resource element, applied along the trailing
    receive-antenna axis of h_hat [batch, num_rx, num_tx, num_streams,
    sym, sc, num_rx_ant]."""

    def __init__(self, cov_mat, last_step=True):
        cov_mat = np.asarray(cov_mat)
        super().__init__(precision="single" if cov_mat.dtype == np.complex64
                         else "double")
        r = cov_mat.astype(self.np_cdtype)
        self._host = {"r": r, "r_t": np.ascontiguousarray(r.T),
                      "diag_r": np.real(np.diagonal(r)).astype(
                          self.np_rdtype)}
        self._last_step = bool(last_step)
        self._cache = {}

    def __call__(self, h_hat, err_var):
        h_hat = torch.as_tensor(h_hat).to(self.cdtype)
        c = _on(self._cache, h_hat.device, self._host)
        err_var = torch.as_tensor(err_var).to(
            device=h_hat.device, dtype=self.rdtype).expand(h_hat.shape)
        r = c["r"]
        err_c = torch.clamp_min(err_var, 1e-12)
        s_mat = r + torch.diag_embed(err_c.to(self.cdtype))
        # A^T = solve(S^T, R^T), so A = R S^{-1}
        a = torch.linalg.solve(s_mat.transpose(-2, -1),
                               c["r_t"].expand(s_mat.shape)
                               ).transpose(-2, -1)
        h_out = torch.matmul(a, h_hat[..., None])[..., 0]
        err_out = torch.clamp_min(
            c["diag_r"] - torch.sum(a * c["r_t"], dim=-1).real, 0.)

        if not self._last_step:
            var1 = torch.sum(torch.matmul(a, r) * torch.conj(a),
                             dim=-1).real
            var2 = torch.sum(torch.abs(a) ** 2 * err_c[..., None, :],
                             dim=-1)
            h_hat_var = var1 + var2
            h_var = c["diag_r"]
            denom = h_hat_var + h_var - err_out
            s = torch.where(torch.abs(denom) > 1e-12, 2. * h_var / denom,
                            torch.zeros_like(denom))
            h_out = s.to(self.cdtype) * h_out
            err_out = torch.clamp_min(
                s * (s - 1.) * h_hat_var + (1. - s) * h_var + s * err_out,
                0.)
        return h_out, err_out
