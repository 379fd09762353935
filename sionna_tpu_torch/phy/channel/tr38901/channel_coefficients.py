"""TR 38.901 steps 10-11: channel coefficient generation (counterpart of
``sionna_tpu/phy/channel/tr38901/channel_coefficients.py``).

The random phases of step 10 are drawn in ``__call__``; step 11 is the
deterministic ``_step_11``, which takes them. Step 11 forms, per ray,
the polarized field, array and power factor
[b, tx, rx, clusters, rays, rx_ant, tx_ant] and the Doppler phasors
[b, tx, rx, clusters, rays, time], and sums over the rays of each
cluster (or sub-cluster) as one batched matrix product: the product over
rays and time steps is never held in memory (the JAX package forms it
and reduces; the sums are the same up to their order). The field
factors are computed in float64 where the JAX package's NumPy scalars
promote them, then cast to the complex dtype as there.
"""

import numpy as np
import torch

from ...block import Object
from ...config import config
from ...constants import PI, SPEED_OF_LIGHT

__all__ = ["Topology", "ChannelCoefficientsGenerator"]


def _exp_j(x, cdtype):
    """exp(1j x) of real ``x`` in ``cdtype``."""
    return torch.complex(torch.cos(x), torch.sin(x)).to(cdtype)


class Topology(Object):
    """Network topology container.

    velocities: [batch, num_tx or num_rx (the moving end), 3];
    moving_end: "tx" or "rx"; los_aoa/los_aod/los_zoa/los_zod, los,
    distance_3d: [batch, num_tx, num_rx] (los may also be one bool for
    every link); tx_orientations: [batch, num_tx, 3]; rx_orientations:
    [batch, num_rx, 3].
    """

    def __init__(self, velocities, moving_end, los_aoa, los_aod,
                 los_zoa, los_zod, los, distance_3d, tx_orientations,
                 rx_orientations):
        super().__init__()
        self.velocities = velocities
        self.moving_end = moving_end
        self.los_aoa = los_aoa
        self.los_aod = los_aod
        self.los_zoa = los_zoa
        self.los_zod = los_zod
        self.los = los
        self.distance_3d = distance_3d
        self.tx_orientations = tx_orientations
        self.rx_orientations = rx_orientations


class ChannelCoefficientsGenerator(Object):
    """Samples channel impulse responses from rays and a topology
    (TR 38.901 Sec. 7.5 steps 10-11).

    Call with ``(num_time_samples, sampling_frequency, k_factor, rays,
    topology, c_ds=None, debug=False)`` and optionally ``generator=``
    (a ``torch.Generator``; default ``config.generator`` of the rays'
    device). Returns ``(h [b, tx, rx, clusters, rx_ant, tx_ant, time],
    delays [b, tx, rx, clusters])``, with ``(phi, sample_times)`` added
    when ``debug``.
    """

    # Sub-cluster info, Table 7.5-5
    _SUB_CL_1_IND = np.array([0, 1, 2, 3, 4, 5, 6, 7, 18, 19])
    _SUB_CL_2_IND = np.array([8, 9, 10, 11, 16, 17])
    _SUB_CL_3_IND = np.array([12, 13, 14, 15])
    _SUB_CL_DELAY_OFFSETS = np.array([0., 1.28, 2.56])

    def __init__(self, carrier_frequency, tx_array, rx_array,
                 subclustering, precision=None):
        super().__init__(precision=precision)
        self._lambda_0 = SPEED_OF_LIGHT / carrier_frequency
        self._tx_array = tx_array
        self._rx_array = rx_array
        self._subclustering = bool(subclustering)
        self._tables = {}

    def _array_tables(self, array, device):
        """An array's element positions [num_ant, 3] and, per antenna,
        its polarization (0 or 1), on ``device``: made once per device,
        so that a call copies nothing from the host."""
        key = (id(array), device)
        if key not in self._tables:
            pol = np.zeros([array.num_ant], np.int64)
            if array.polarization == "dual":
                pol[array.ant_ind_pol2] = 1
            self._tables[key] = (
                torch.as_tensor(array.ant_pos, device=device).to(self.rdtype),
                torch.as_tensor(pol, device=device))
        return self._tables[key]

    def __call__(self, num_time_samples, sampling_frequency, k_factor,
                 rays, topology, c_ds=None, debug=False, generator=None):
        dev = rays.aoa.device
        if generator is None:
            generator = config.generator(dev)
        # Step 10: random phases [b, tx, rx, cl, rays, 4]
        u = torch.rand(tuple(rays.aoa.shape) + (4,), generator=generator,
                       dtype=self.rdtype, device=dev)
        phi = u * (2 * PI) - PI
        sample_times = self.sample_times(num_time_samples,
                                         sampling_frequency, dev)
        h, delays = self._step_11(phi, topology, k_factor, rays,
                                  sample_times, c_ds)
        if debug:
            return h, delays, phi, sample_times
        return h, delays

    def sample_times(self, num_time_samples, sampling_frequency, device):
        """The sampling instants [num_time_samples] in seconds."""
        return (torch.arange(num_time_samples, dtype=self.rdtype,
                             device=device) / sampling_frequency)

    # ------------------------------------------------------------------
    # Geometry helpers (TR 38.901 Sec. 7.1)
    # ------------------------------------------------------------------
    # Each sine and cosine below is taken once (XLA merges the JAX
    # package's repeated ones; eager torch would launch each).
    @staticmethod
    def _unit_sphere_vector(theta, phi):
        """(7.1-6): [..., 3] unit vector."""
        sin_theta = torch.sin(theta)
        return torch.stack([sin_theta * torch.cos(phi),
                            sin_theta * torch.sin(phi),
                            torch.cos(theta)], dim=-1)

    @staticmethod
    def _forward_rotation_matrix(orientations):
        """(7.1-4): [..., 3, 3] composite rotation."""
        ca, cb, cc = torch.cos(orientations).unbind(-1)
        sa, sb, sc = torch.sin(orientations).unbind(-1)
        row_1 = torch.stack([ca * cb,
                             ca * sb * sc - sa * cc,
                             ca * sb * cc + sa * sc], dim=-1)
        row_2 = torch.stack([sa * cb,
                             sa * sb * sc + ca * cc,
                             sa * sb * cc - ca * sc], dim=-1)
        row_3 = torch.stack([-sb, cb * sc, cb * cc], dim=-1)
        return torch.stack([row_1, row_2, row_3], dim=-2)

    def _gcs_to_lcs(self, orientations, theta, phi):
        """(7.1-7/8): angles in the local coordinate system."""
        rho_hat = self._unit_sphere_vector(theta, phi)[..., None]
        rot_inv = self._forward_rotation_matrix(orientations).transpose(
            -2, -1)
        rot_rho = torch.matmul(rot_inv, rho_hat)[..., 0]  # [..., 3]
        z = torch.clamp(rot_rho[..., 2], -1., 1.)
        theta_prime = torch.arccos(z)
        phi_prime = torch.atan2(rot_rho[..., 1], rot_rho[..., 0])
        return theta_prime, phi_prime

    @staticmethod
    def _compute_psi(orientations, theta, phi):
        """(7.1-15): displacement angle psi."""
        _, cb, cc = torch.cos(orientations).unbind(-1)
        _, sb, sc = torch.sin(orientations).unbind(-1)
        phi_a = phi - orientations[..., 0]
        cos_phi_a, sin_phi_a = torch.cos(phi_a), torch.sin(phi_a)
        cos_theta = torch.cos(theta)
        real = sc * cos_theta * sin_phi_a \
            + cc * (cb * torch.sin(theta) - sb * cos_theta * cos_phi_a)
        imag = sc * cos_phi_a + sb * cc * sin_phi_a
        return torch.atan2(imag, real)

    @staticmethod
    def _l2g_response(f_prime, cos_psi, sin_psi):
        """(7.1-11): LCS field components (F_theta, F_phi), float64, to
        the GCS by the displacement angle psi (its cosine and sine,
        float64): [..., 2] float64."""
        f0, f1 = f_prime
        return torch.stack([cos_psi * f0 - sin_psi * f1,
                            sin_psi * f0 + cos_psi * f1], dim=-1)

    def _antenna_positions_gcs(self, orientations, array, device):
        """d_bar (7.5-22): [batch, n, num_ant, 3] for orientations
        [batch, n, 3]."""
        rot = self._forward_rotation_matrix(
            torch.as_tensor(orientations).to(self.rdtype)[:, :, None])
        pos = self._array_tables(array, device)[0][None, None, :, :, None]
        return torch.matmul(rot, pos)[..., 0]

    # ------------------------------------------------------------------
    # Step 11 pieces
    # ------------------------------------------------------------------
    def _step_11_phase_matrix(self, phi, rays):
        """(7.5-22) phase/XPR matrix: [b, tx, rx, cl, rays, 2, 2]
        complex."""
        xpr = torch.as_tensor(rays.xpr).to(self.rdtype)
        xpr_scaling = torch.sqrt(1 / xpr).to(self.cdtype)
        e = _exp_j(phi, self.cdtype)
        h_phase = torch.stack([e[..., 0], xpr_scaling * e[..., 1],
                               xpr_scaling * e[..., 2], e[..., 3]], dim=-1)
        return h_phase.reshape(h_phase.shape[:-1] + (2, 2))

    def _step_11_doppler_matrix(self, topology, aoa, zoa, t):
        """(7.5-22) Doppler factor: [b, tx, rx, cl, rays, time]
        complex."""
        v_bar = torch.as_tensor(topology.velocities).to(self.rdtype)
        if topology.moving_end == "rx":
            v_bar = v_bar[:, None]        # [b, 1, rx, 3]
        else:
            v_bar = v_bar[:, :, None]     # [b, tx, 1, 3]
        v_bar = v_bar[:, :, :, None, None]  # [b, ., ., 1, 1, 3]
        r_hat_rx = self._unit_sphere_vector(zoa, aoa)
        exponent = (2 * PI / self._lambda_0
                    * torch.sum(r_hat_rx * v_bar, dim=-1))[..., None] * t
        return _exp_j(exponent, self.cdtype)

    def _step_11_array_offsets(self, topology, aoa, aod, zoa, zod):
        """(7.5-22) element phase offsets: [b, tx, rx, cl, rays,
        rx_ant, tx_ant] complex."""
        dev = aoa.device
        r_hat_rx = self._unit_sphere_vector(zoa, aoa)[..., None, :]
        r_hat_tx = self._unit_sphere_vector(zod, aod)[..., None, :]
        d_bar_rx = self._antenna_positions_gcs(
            topology.rx_orientations, self._rx_array, dev)
        d_bar_tx = self._antenna_positions_gcs(
            topology.tx_orientations, self._tx_array, dev)
        # r_hat [b, tx, rx, cl, rays, 1, 3]; d_rx [b, 1, rx, 1, 1,
        # rx_ant, 3]; d_tx [b, tx, 1, 1, 1, tx_ant, 3]
        d_bar_rx = d_bar_rx[:, None, :, None, None]
        d_bar_tx = d_bar_tx[:, :, None, None, None]
        exp_rx = 2 * PI / self._lambda_0 * torch.sum(r_hat_rx * d_bar_rx,
                                                     dim=-1)
        exp_tx = 2 * PI / self._lambda_0 * torch.sum(r_hat_tx * d_bar_tx,
                                                     dim=-1)
        exp_rx = _exp_j(exp_rx, self.cdtype)
        exp_tx = _exp_j(exp_tx, self.cdtype)
        return exp_rx[..., :, None] * exp_tx[..., None, :]

    def _array_field(self, array, theta_prime, phi_prime, orient, theta,
                     phi):
        """Per antenna, its element's GCS field (F_theta, F_phi):
        [..., num_ant, 2] float64. The JAX package takes psi's cosine and
        sine in the real dtype and promotes them, as here."""
        psi = self._compute_psi(orient, theta, phi)
        cos_psi = torch.cos(psi).to(torch.float64)
        sin_psi = torch.sin(psi).to(torch.float64)
        f1 = self._l2g_response(array.ant_pol1.field(theta_prime, phi_prime),
                                cos_psi, sin_psi)
        if array.polarization == "single":
            return f1[..., None, :].expand(f1.shape[:-1]
                                           + (array.num_ant, 2))
        f2 = self._l2g_response(array.ant_pol2.field(theta_prime, phi_prime),
                                cos_psi, sin_psi)
        pol = self._array_tables(array, f1.device)[1]
        return torch.stack([f1, f2], dim=-2)[..., pol, :]

    def _step_11_field_matrix(self, topology, aoa, aod, zoa, zod,
                              h_phase):
        """(7.5-22) polarized element responses: [b, tx, rx, cl, rays,
        rx_ant, tx_ant] complex, sum_p F_rx[p] (H_phase F_tx)[p]."""
        tx_orient = torch.as_tensor(topology.tx_orientations).to(
            self.rdtype)[:, :, None, None, None, :]
        rx_orient = torch.as_tensor(topology.rx_orientations).to(
            self.rdtype)[:, None, :, None, None, :]
        zod_prime, aod_prime = self._gcs_to_lcs(tx_orient, zod, aod)
        zoa_prime, aoa_prime = self._gcs_to_lcs(rx_orient, zoa, aoa)
        f_tx = self._array_field(self._tx_array, zod_prime, aod_prime,
                                 tx_orient, zod, aod).to(self.cdtype)
        f_rx = self._array_field(self._rx_array, zoa_prime, aoa_prime,
                                 rx_orient, zoa, aoa).to(self.cdtype)
        # H_phase F_tx per tx antenna: [..., tx_ant, 2]
        pol_tx = torch.stack(
            [h_phase[..., None, 0, 0] * f_tx[..., 0]
             + h_phase[..., None, 0, 1] * f_tx[..., 1],
             h_phase[..., None, 1, 0] * f_tx[..., 0]
             + h_phase[..., None, 1, 1] * f_tx[..., 1]], dim=-1)
        return (f_rx[..., :, None, 0] * pol_tx[..., None, :, 0]
                + f_rx[..., :, None, 1] * pol_tx[..., None, :, 1])

    def _step_11_nlos(self, phi, topology, rays, t):
        """(7.5-28) factors of the NLoS rays: the per-ray field, array
        and power product [b, tx, rx, cl, rays, rx_ant, tx_ant] and the
        Doppler phasors [b, tx, rx, cl, rays, time]."""
        h_phase = self._step_11_phase_matrix(phi, rays)
        h_field = self._step_11_field_matrix(topology, rays.aoa, rays.aod,
                                             rays.zoa, rays.zod, h_phase)
        h_array = self._step_11_array_offsets(topology, rays.aoa, rays.aod,
                                              rays.zoa, rays.zod)
        h_doppler = self._step_11_doppler_matrix(topology, rays.aoa,
                                                 rays.zoa, t)
        num_rays = h_field.shape[4]
        power_scaling = torch.sqrt(
            torch.as_tensor(rays.powers).to(self.rdtype) / num_rays
        ).to(self.cdtype)
        coef = h_field * h_array * power_scaling[..., None, None, None]
        return coef, h_doppler

    @staticmethod
    def _ray_sum(coef, doppler):
        """sum over rays of coef [..., rays, rxa, txa] x doppler [...,
        rays, T]: [..., rxa, txa, T], as one batched matrix product."""
        doppler = doppler.expand(coef.shape[:-2] + doppler.shape[-1:])
        lead = coef.shape[:-3]
        r, rxa, txa = coef.shape[-3:]
        c = coef.reshape(-1, r, rxa * txa).transpose(1, 2)
        d = doppler.reshape(-1, r, doppler.shape[-1])
        out = torch.bmm(c, d)
        return out.reshape(lead + (rxa, txa, d.shape[-1]))

    def _step_11_reduce_nlos(self, coef, doppler, rays, c_ds):
        """(7.5-27): sum the rays of each cluster; with subclustering,
        split the two strongest clusters into three sub-clusters. Sorts
        the clusters by delay. Returns h_nlos [b, tx, rx, cl, rxa, txa,
        T] and the delays."""
        dev = coef.device
        delays = torch.as_tensor(rays.delays).to(self.rdtype)
        if not self._subclustering:
            h_nlos = self._ray_sum(coef, doppler)
            delays_nlos = delays
        else:
            powers = torch.as_tensor(rays.powers).to(self.rdtype)
            strongest = torch.argsort(-powers, dim=-1, stable=True)
            delays_sorted = torch.gather(delays, 3, strongest)
            delays_strong = delays_sorted[..., :2]
            delays_weak = delays_sorted[..., 2:]
            offsets = torch.as_tensor(self._SUB_CL_DELAY_OFFSETS,
                                      dtype=self.rdtype, device=dev)
            c_ds = torch.as_tensor(c_ds).to(device=dev, dtype=self.rdtype)
            delays_sub_cl = (delays_strong[..., None, :]
                             + offsets[:, None] * c_ds[..., None, None])
            delays_sub_cl = delays_sub_cl.reshape(
                delays_sub_cl.shape[:-2] + (-1,))

            def clusters(idx, x):
                idx = idx.reshape(idx.shape + (1,) * (x.dim() - 4))
                return torch.gather(x, 3, idx.expand(idx.shape[:4]
                                                     + x.shape[4:]))

            doppler = doppler.expand(coef.shape[:5] + doppler.shape[-1:])
            c_strong = clusters(strongest[..., :2], coef)
            d_strong = clusters(strongest[..., :2], doppler)
            c_weak = clusters(strongest[..., 2:], coef)
            d_weak = clusters(strongest[..., 2:], doppler)
            subs = []
            for ind in (self._SUB_CL_1_IND, self._SUB_CL_2_IND,
                        self._SUB_CL_3_IND):
                ind = torch.as_tensor(ind, device=dev)
                subs.append(self._ray_sum(c_strong[:, :, :, :, ind],
                                          d_strong[:, :, :, :, ind]))
            h_nlos = torch.cat(subs + [self._ray_sum(c_weak, d_weak)],
                               dim=3)
            delays_nlos = torch.cat([delays_sub_cl, delays_weak], dim=3)
        # sort by delay
        delays_ind = torch.argsort(delays_nlos, dim=-1, stable=True)
        delays_nlos = torch.gather(delays_nlos, 3, delays_ind)
        idx = delays_ind[..., None, None, None].expand(
            delays_ind.shape + h_nlos.shape[4:])
        h_nlos = torch.gather(h_nlos, 3, idx)
        return h_nlos, delays_nlos

    def _step_11_los(self, topology, t):
        """(7.5-29): LoS component [b, tx, rx, 1, rxa, txa, time]."""
        def angle(x):
            return torch.as_tensor(x).to(self.rdtype)[..., None, None]

        aoa, aod = angle(topology.los_aoa), angle(topology.los_aod)
        zoa, zod = angle(topology.los_zoa), angle(topology.los_zod)
        h_phase = torch.tensor([[1., 0.], [0., -1.]], dtype=self.cdtype,
                               device=aoa.device).reshape(
                                   [1, 1, 1, 1, 1, 2, 2])
        h_field = self._step_11_field_matrix(topology, aoa, aod, zoa, zod,
                                             h_phase)
        h_array = self._step_11_array_offsets(topology, aoa, aod, zoa, zod)
        h_doppler = self._step_11_doppler_matrix(topology, aoa, zoa, t)
        d3d = torch.as_tensor(topology.distance_3d).to(self.rdtype)
        h_delay = _exp_j(2 * PI * d3d / self._lambda_0, self.cdtype)
        # squeeze the rays dim (size 1), keep the cluster dim
        h_field = h_field[:, :, :, :, 0][..., None]
        h_array = h_array[:, :, :, :, 0][..., None]
        h_doppler = h_doppler[:, :, :, :, 0][..., None, None, :]
        h_delay = h_delay[..., None, None, None, None]
        return h_field * h_array * h_doppler * h_delay

    def _step_11(self, phi, topology, k_factor, rays, t, c_ds):
        """(7.5-30): combine LoS and NLoS. ``topology.los`` may be one
        bool for every link (as a CDL model gives it): False skips the
        LoS component, which every link would drop."""
        coef, doppler = self._step_11_nlos(phi, topology, rays, t)
        h_nlos, delays_nlos = self._step_11_reduce_nlos(coef, doppler, rays,
                                                        c_ds)
        if topology.los is False:
            return h_nlos, delays_nlos
        h_los_los_comp = self._step_11_los(topology, t)
        k = torch.as_tensor(k_factor).to(self.rdtype)
        k = k[..., None, None, None, None].to(self.cdtype)
        h_los_los_comp = h_los_los_comp * torch.sqrt(k / (k + 1))
        h_los_nlos_comp = h_nlos * torch.sqrt(1 / (k + 1))
        h_los_cl = h_los_los_comp + h_los_nlos_comp[:, :, :, :1]
        h_los = torch.cat([h_los_cl, h_los_nlos_comp[:, :, :, 1:]], dim=3)
        if topology.los is True:
            return h_los, delays_nlos
        los_ind = torch.as_tensor(topology.los, device=h_nlos.device)[
            ..., None, None, None, None]
        return torch.where(los_ind, h_los, h_nlos), delays_nlos
