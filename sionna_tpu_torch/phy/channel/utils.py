"""Channel utility functions (counterpart of
``sionna_tpu/phy/channel/utils.py``)."""

import numpy as np
import torch

from ..config import config, dtypes
from ..constants import PI
from ..utils.misc import _rdtype

__all__ = ["subcarrier_frequencies", "time_frequency_vector",
           "time_lag_discrete_time_channel", "cir_to_ofdm_channel",
           "cir_to_time_channel", "time_to_ofdm_channel", "deg_2_rad",
           "rad_2_deg", "wrap_angle_0_360", "exp_corr_mat",
           "one_ring_corr_mat", "drop_uts_in_sector",
           "set_3gpp_scenario_parameters", "relocate_uts",
           "random_ut_properties", "generate_uts_topology",
           "gen_single_sector_topology",
           "gen_single_sector_topology_interferers"]


def _cdtype(precision):
    return config.cdtype if precision is None \
        else dtypes[precision]["torch"]["cdtype"]


def subcarrier_frequencies(num_subcarriers, subcarrier_spacing,
                           precision=None, device=None):
    """Baseband subcarrier frequencies, DC-centered, on ``device``
    (default ``config.device``)."""
    rdtype = _rdtype(precision)
    start = -(num_subcarriers // 2)
    limit = num_subcarriers // 2 + (num_subcarriers % 2)
    freqs = torch.arange(start, limit, dtype=rdtype,
                         device=config.device if device is None else device)
    return freqs * subcarrier_spacing


def cir_to_ofdm_channel(frequencies, a, tau, normalize=False):
    """Channel frequency response h(f) = sum_m a_m exp(-j2 pi f tau_m).

    a: [b, rx, rxa, tx, txa, paths, T]; tau: [b, rx, tx, paths] or
    [b, rx, rxa, tx, txa, paths]. Returns
    [b, rx, rxa, tx, txa, T, fft_size]. The sum over paths is a batched
    matrix product [T, paths] x [paths, fft_size].
    """
    a = torch.as_tensor(a)
    tau = torch.as_tensor(tau)
    if tau.dim() == 4:
        tau = tau[:, :, None, :, None, :]
    freqs = torch.as_tensor(frequencies, dtype=tau.dtype, device=tau.device)
    phase = 2 * PI * freqs * tau[..., None]  # [..., paths, fft_size]
    e = torch.complex(torch.cos(phase), -torch.sin(phase)).to(a.dtype)
    h_f = torch.matmul(a.transpose(-1, -2), e)  # [..., T, fft_size]

    if normalize:
        c = torch.mean(torch.abs(h_f) ** 2, dim=(2, 4, 5, 6), keepdim=True)
        c = torch.sqrt(c)
        h_f = torch.where(c == 0, torch.zeros_like(h_f),
                          h_f / torch.where(c == 0, torch.ones_like(c), c))
    return h_f


def time_frequency_vector(num_samples, sample_duration, precision=None,
                          device=None):
    """Time and frequency vectors of ``num_samples`` samples, centered
    on 0."""
    rdtype = _rdtype(precision)
    num_samples = int(num_samples)
    n_min = num_samples // 2
    n_max = num_samples - n_min - 1
    n = torch.linspace(-n_min, n_max, num_samples, dtype=torch.float64,
                       device=device).to(rdtype)
    return n * sample_duration, n * (1 / (sample_duration * num_samples))


def time_lag_discrete_time_channel(bandwidth, maximum_delay_spread=3e-6):
    """Recommended (l_min, l_max) of the discrete-time channel's taps."""
    return -6, int(np.ceil(maximum_delay_spread * bandwidth) + 6)


def cir_to_time_channel(bandwidth, a, tau, l_min, l_max, normalize=False):
    """Discrete-time channel taps for sinc pulse shaping,
    h[l] = sum_m a_m sinc(l - W tau_m).

    a: [b, rx, rxa, tx, txa, paths, T]; tau: [b, rx, tx, paths] or
    [b, rx, rxa, tx, txa, paths]. Returns
    [b, rx, rxa, tx, txa, T, l_max - l_min + 1]. The sum over paths is a
    batched matrix product [T, paths] x [paths, taps].
    """
    a = torch.as_tensor(a)
    tau = torch.as_tensor(tau)
    if tau.dim() == 4:
        tau = tau[:, :, None, :, None, :]
    l = torch.arange(l_min, l_max + 1, dtype=tau.dtype, device=tau.device)
    sinc = torch.sinc(l - bandwidth * tau[..., None]).to(a.dtype)
    hm = torch.matmul(a.transpose(-1, -2), sinc)  # [..., T, taps]

    if normalize:
        c = torch.mean(torch.sum(torch.abs(hm) ** 2, dim=-1),
                       dim=(2, 4, 5), keepdim=True)[..., None]
        c = torch.sqrt(c).to(a.dtype)
        hm = torch.where(c == 0, torch.zeros_like(hm),
                         hm / torch.where(c == 0, torch.ones_like(c), c))
    return hm


def time_to_ofdm_channel(h_t, rg, l_min):
    """Frequency response of each OFDM symbol from discrete-time taps
    ``h_t`` [..., num_time_samples, l_max - l_min + 1]: the taps at the
    start of each symbol (after its cyclic prefix), zero-padded to
    ``fft_size`` with the negative lags wrapped, through an FFT."""
    h_t = torch.as_tensor(h_t)
    fft_size = rg.fft_size
    cp = rg.cyclic_prefix_length
    start_idx = cp + (fft_size + cp) * np.arange(rg.num_ofdm_symbols)
    start_idx = start_idx[start_idx < h_t.shape[-2]]
    h = torch.index_select(h_t, -2, torch.as_tensor(start_idx,
                                                    device=h_t.device))
    l_max = l_min + h.shape[-1] - 1
    h_pad = torch.zeros(h.shape[:-1] + (fft_size,), dtype=h.dtype,
                        device=h.device)
    # lags 0..l_max at positions 0..l_max, lags l_min..-1 wrapped to
    # fft_size + l_min .. fft_size - 1
    h_pad[..., :l_max + 1] = h[..., -l_min:]
    h_pad[..., fft_size + l_min:] = h[..., :-l_min]
    return torch.fft.fftshift(torch.fft.fft(h_pad, dim=-1), dim=-1)


def deg_2_rad(x):
    """Degrees to radians."""
    x = torch.as_tensor(x)
    return x * (PI / 180.0)


def rad_2_deg(x):
    """Radians to degrees."""
    x = torch.as_tensor(x)
    return x * (180.0 / PI)


def wrap_angle_0_360(angle):
    """Wraps angles in degrees to [0, 360)."""
    return torch.remainder(torch.as_tensor(angle), 360.)


def exp_corr_mat(a, n, precision=None, device=None):
    """Exponential correlation matrix R[i, j] = a^|i-j|, conjugated below
    the diagonal: [..., n, n] for coefficients ``a`` of shape [...]
    ([n, n] for one coefficient)."""
    cdtype = _cdtype(precision)
    a = torch.as_tensor(a, device=device).to(cdtype)
    if a.dim() == 0:
        a = a[None]
    i = torch.arange(n, device=a.device)
    d = (i[:, None] - i[None, :]).to(a.real.dtype)  # i - j
    mag = torch.abs(a)[..., None, None]
    phase = torch.angle(a)[..., None, None]
    r = (mag ** torch.abs(d)) * torch.exp(1j * (phase * d)).to(cdtype)
    # one coefficient (a scalar or a vector of one) gives one matrix
    return r[0] if a.dim() == 1 and a.shape[0] == 1 else r


def one_ring_corr_mat(phi_deg, num_ant, d_h=0.5, sigma_phi_deg=15,
                      precision=None, device=None):
    """One-ring correlation matrix of a uniform linear array (Gaussian
    local scattering, small-angle expansion): [..., num_ant, num_ant]
    for angles ``phi_deg`` of shape [...]."""
    rdtype, cdtype = _rdtype(precision), _cdtype(precision)
    phi = deg_2_rad(torch.as_tensor(phi_deg, device=device).to(rdtype))
    sigma_phi = deg_2_rad(torch.as_tensor(sigma_phi_deg).to(rdtype))
    scalar = phi.dim() == 0
    if scalar:
        phi = phi[None]
    i = torch.arange(num_ant, device=phi.device)
    d = (i[:, None] - i[None, :]).to(rdtype)  # antenna offsets
    c = 2 * PI * d_h * d
    phi_e = phi[..., None, None]
    arg = c * torch.sin(phi_e)
    exp_arg = torch.complex(
        -0.5 * (sigma_phi.to(phi.device) ** 2) * (c * torch.cos(phi_e)) ** 2,
        arg)
    r = torch.exp(exp_arg).to(cdtype)
    return r[0] if scalar else r


# ----------------------------------------------------------------------
# 3GPP system-level topology helpers. A drop is host bookkeeping made
# once: NumPy drawing from ``config.np_rng`` with the JAX package's calls
# in its order, so that one seed gives both packages the same topology.
# They return NumPy arrays for ``set_topology``.
# ----------------------------------------------------------------------

def _np_rdtype(precision):
    return np.float64 if (precision or config.precision) == "double" \
        else np.float32


def drop_uts_in_sector(batch_size, num_ut, min_bs_ut_dist, isd,
                       bs_height=0., ut_height=0., precision=None):
    """Uniformly samples UT locations within a 120-deg cell sector
    centered on a BS at the origin.

    Returns [batch_size, num_ut, 2] X-Y locations."""
    rdtype = _np_rdtype(precision)
    rng = config.np_rng
    d_min = max(float(min_bs_ut_dist), abs(float(bs_height)
                                           - float(ut_height)))
    r = 0.5 * float(isd)
    r_min2 = d_min ** 2 - (float(bs_height) - float(ut_height)) ** 2

    alpha_half = rng.uniform(-PI / 6., PI / 6., (batch_size, num_ut))
    r_max = r / np.cos(alpha_half)
    # Uniform area density: sample squared distance uniformly
    distance = np.sqrt(rng.uniform(size=(batch_size, num_ut))
                       * (r_max ** 2 - r_min2) + r_min2)
    side = rng.integers(0, 2, (batch_size, num_ut)) * 2. + 1.
    alpha = alpha_half + side * PI / 6.
    return np.stack([distance * np.cos(alpha),
                     distance * np.sin(alpha)],
                    axis=-1).astype(rdtype)


def set_3gpp_scenario_parameters(scenario, min_bs_ut_dist=None,
                                 isd=None, bs_height=None,
                                 min_ut_height=None, max_ut_height=None,
                                 indoor_probability=None,
                                 min_ut_velocity=None,
                                 max_ut_velocity=None, precision=None):
    """Default drop parameters for the 3GPP system-level scenarios."""
    defaults = {
        "umi": (10., 200., 10., 1.5, 1.5, 0.8, 0.0, 0.0),
        "umi-calibration": (0., 200., 10., 1.5, 1.5, 0.8,
                            3. / 3.6, 3. / 3.6),
        "uma": (35., 500., 25., 1.5, 1.5, 0.8, 0.0, 0.0),
        "uma-calibration": (0., 500., 25., 1.5, 1.5, 0.8,
                            3. / 3.6, 3. / 3.6),
        "rma": (35., 5000., 35., 1.5, 1.5, 0.5, 0.0, 0.0),
    }
    if scenario not in defaults:
        raise ValueError(
            "`scenario` must be one of 'umi', 'uma', 'rma', "
            "'umi-calibration', 'uma-calibration'")
    d = defaults[scenario]
    vals = [min_bs_ut_dist, isd, bs_height, min_ut_height,
            max_ut_height, indoor_probability, min_ut_velocity,
            max_ut_velocity]
    return tuple(float(d[i]) if v is None else float(v)
                 for i, v in enumerate(vals))


def relocate_uts(ut_loc, sector_id, cell_loc):
    """Rotates UTs (assumed dropped in sector 0 of the origin cell)
    into ``sector_id`` and translates them to ``cell_loc``."""
    ut_loc = np.asarray(ut_loc)
    sector_id = np.asarray(sector_id, ut_loc.dtype)
    while sector_id.ndim < 2:
        sector_id = sector_id[None]
    cell_loc = np.asarray(cell_loc, ut_loc.dtype)
    while cell_loc.ndim < ut_loc.ndim:
        cell_loc = cell_loc[None]

    angle = sector_id * 2. * PI / 3.0
    rot = np.stack([np.cos(angle), -np.sin(angle),
                    np.sin(angle), np.cos(angle)], axis=-1)
    rot = rot.reshape(angle.shape + (2, 2))
    ut_loc_rot = np.squeeze(rot @ ut_loc[..., None], axis=-1)
    return ut_loc_rot + cell_loc


def random_ut_properties(batch_size, num_ut, indoor_probability,
                         min_ut_velocity, max_ut_velocity,
                         precision=None):
    """Random UT orientations, planar velocities and indoor states."""
    rdtype = _np_rdtype(precision)
    rng = config.np_rng
    in_state = rng.uniform(size=(batch_size, num_ut)) \
        < float(indoor_probability)

    vel_angle = rng.uniform(-PI, PI, (batch_size, num_ut))
    vel_norm = rng.uniform(float(min_ut_velocity),
                           float(max_ut_velocity) + 1e-12,
                           (batch_size, num_ut))
    ut_velocities = np.stack(
        [vel_norm * np.cos(vel_angle), vel_norm * np.sin(vel_angle),
         np.zeros((batch_size, num_ut))], axis=-1).astype(rdtype)

    ut_orientations = rng.uniform(
        -0.5 * PI, 0.5 * PI, (batch_size, num_ut, 3)).astype(rdtype)
    return ut_orientations, ut_velocities, in_state


def generate_uts_topology(batch_size, num_ut, drop_area, cell_loc_xy,
                          min_bs_ut_dist, isd, min_ut_height,
                          max_ut_height, indoor_probability,
                          min_ut_velocity, max_ut_velocity,
                          precision=None):
    """Samples UT locations from a sector or a whole cell."""
    if drop_area not in ("sector", "cell"):
        raise ValueError("drop_area must be 'sector' or 'cell'")
    rdtype = _np_rdtype(precision)
    rng = config.np_rng

    ut_loc_xy = drop_uts_in_sector(batch_size, num_ut, min_bs_ut_dist,
                                   isd, precision=precision)
    if drop_area == "sector":
        sectors = np.zeros((batch_size, num_ut), np.int32)
    else:
        sectors = rng.integers(0, 3, (batch_size, num_ut))
    ut_loc_xy = relocate_uts(ut_loc_xy, sectors, cell_loc_xy)

    ut_loc_z = rng.uniform(float(min_ut_height),
                           float(max_ut_height) + 1e-12,
                           (batch_size, num_ut, 1))
    ut_loc = np.concatenate([ut_loc_xy, ut_loc_z],
                            axis=-1).astype(rdtype)

    ut_orientations, ut_velocities, in_state = random_ut_properties(
        batch_size, num_ut, indoor_probability, min_ut_velocity,
        max_ut_velocity, precision)
    return ut_loc, ut_orientations, ut_velocities, in_state


def _single_sector_bs(batch_size, min_bs_ut_dist, isd, bs_height,
                      rdtype):
    """BS at the origin, downtilted towards the sector center."""
    bs_loc = np.zeros((batch_size, 1, 3), rdtype)
    bs_loc[:, :, 2] = bs_height
    sector_center = (min_bs_ut_dist + 0.5 * isd) * 0.5
    bs_downtilt = 0.5 * PI - np.arctan(sector_center / bs_height)
    bs_orientation = np.zeros((batch_size, 1, 3), rdtype)
    bs_orientation[:, :, 0] = PI / 3.0
    bs_orientation[:, :, 1] = bs_downtilt
    return bs_loc, bs_orientation


def gen_single_sector_topology(batch_size, num_ut, scenario,
                               min_bs_ut_dist=None, isd=None,
                               bs_height=None, min_ut_height=None,
                               max_ut_height=None,
                               indoor_probability=None,
                               min_ut_velocity=None,
                               max_ut_velocity=None, precision=None):
    """Single-BS, single-sector topology drop.  Returns (ut_loc, bs_loc,
    ut_orientations, bs_orientations, ut_velocities, in_state) ready
    for ``set_topology``."""
    (min_bs_ut_dist, isd, bs_height, min_ut_height, max_ut_height,
     indoor_probability, min_ut_velocity, max_ut_velocity) = \
        set_3gpp_scenario_parameters(
            scenario, min_bs_ut_dist, isd, bs_height, min_ut_height,
            max_ut_height, indoor_probability, min_ut_velocity,
            max_ut_velocity, precision)
    rdtype = _np_rdtype(precision)
    bs_loc, bs_orientation = _single_sector_bs(
        batch_size, min_bs_ut_dist, isd, bs_height, rdtype)
    ut_loc, ut_orientations, ut_velocities, in_state = \
        generate_uts_topology(
            batch_size, num_ut, "sector", np.zeros(2, rdtype),
            min_bs_ut_dist, isd, min_ut_height, max_ut_height,
            indoor_probability, min_ut_velocity, max_ut_velocity,
            precision)
    return (ut_loc, bs_loc, ut_orientations, bs_orientation,
            ut_velocities, in_state)


def gen_single_sector_topology_interferers(
        batch_size, num_ut, num_interferer, scenario,
        min_bs_ut_dist=None, isd=None, bs_height=None,
        min_ut_height=None, max_ut_height=None,
        indoor_probability=None, min_ut_velocity=None,
        max_ut_velocity=None, precision=None):
    """Single-sector topology plus ``num_interferer`` UTs dropped in
    the two adjacent cells.  The first
    ``num_ut`` UTs along axis 1 are the served ones."""
    (min_bs_ut_dist, isd, bs_height, min_ut_height, max_ut_height,
     indoor_probability, min_ut_velocity, max_ut_velocity) = \
        set_3gpp_scenario_parameters(
            scenario, min_bs_ut_dist, isd, bs_height, min_ut_height,
            max_ut_height, indoor_probability, min_ut_velocity,
            max_ut_velocity, precision)
    rdtype = _np_rdtype(precision)
    rng = config.np_rng
    bs_loc, bs_orientation = _single_sector_bs(
        batch_size, min_bs_ut_dist, isd, bs_height, rdtype)

    ut_loc, ut_orientations, ut_velocities, in_state = \
        generate_uts_topology(
            batch_size, num_ut, "sector", np.zeros(2, rdtype),
            min_bs_ut_dist, isd, min_ut_height, max_ut_height,
            indoor_probability, min_ut_velocity, max_ut_velocity,
            precision)

    # Interferers dropped in one of the two adjacent cells
    inter_cell_center = np.array(
        [[0.0, isd],
         [isd * np.cos(PI / 6.0), isd * np.sin(PI / 6.0)]], rdtype)
    cell_index = rng.integers(0, 2, (batch_size, num_interferer))
    inter_cells = inter_cell_center[cell_index]

    inter_loc, inter_orientations, inter_velocities, inter_in_state = \
        generate_uts_topology(
            batch_size, num_interferer, "cell", inter_cells,
            min_bs_ut_dist, isd, min_ut_height, max_ut_height,
            indoor_probability, min_ut_velocity, max_ut_velocity,
            precision)

    ut_loc = np.concatenate([ut_loc, inter_loc], axis=1)
    ut_orientations = np.concatenate(
        [ut_orientations, inter_orientations], axis=1)
    ut_velocities = np.concatenate(
        [ut_velocities, inter_velocities], axis=1)
    in_state = np.concatenate([in_state, inter_in_state], axis=1)
    return (ut_loc, bs_loc, ut_orientations, bs_orientation,
            ut_velocities, in_state)
