"""Rays container and ``RaysGenerator``, TR 38.901 Sec. 7.5 steps 5-9
(counterpart of ``sionna_tpu/phy/channel/tr38901/rays.py``).

``RaysGenerator.__call__`` makes its random draws from a
``torch.Generator`` (``draw``) and hands them to ``rays_from_draws``,
which computes the rays deterministically: the tests feed it the JAX
package's draws. The per-link cluster mask is built on the host when
the topology is set and copied to the scenario's device once.
"""

import numpy as np
import torch

from ...block import Object
from ...config import config
from ...constants import PI

__all__ = ["Rays", "RaysGenerator"]

# Ray offset angles within a cluster, Table 7.5-3
_RAY_OFFSETS = np.array([0.0447, -0.0447, 0.1413, -0.1413,
                         0.2492, -0.2492, 0.3715, -0.3715,
                         0.5129, -0.5129, 0.6797, -0.6797,
                         0.8844, -0.8844, 1.1481, -1.1481,
                         1.5195, -1.5195, 2.1551, -2.1551])

# The angle draws of step 7, in the JAX package's order of keys
ANGLES = ("aoa", "aod", "zoa", "zod")


class Rays(Object):
    """Container for ray parameters.

    delays/powers: [batch, num_tx, num_rx, num_clusters]
    aoa/aod/zoa/zod/xpr: [batch, num_tx, num_rx, num_clusters, num_rays]
    (angles in radian).
    """

    def __init__(self, delays, powers, aoa, aod, zoa, zod, xpr):
        super().__init__()
        self.delays = delays
        self.powers = powers
        self.aoa = aoa
        self.aod = aod
        self.zoa = zoa
        self.zod = zod
        self.xpr = xpr


class RaysGenerator(Object):
    """Samples rays from a scenario and an LSP realization (TR 38.901
    Sec. 7.5 steps 5 to 9)."""

    def __init__(self, scenario):
        super().__init__(precision=scenario.precision)
        self._scenario = scenario

    def __call__(self, lsp, generator=None):
        return self.rays_from_draws(lsp, **self.draw(generator))

    def draw(self, generator=None):
        """The random draws of one call, on the scenario's device:
        ``delay_u`` (uniform in [1e-6, 1), [b, bs, ut, clusters]),
        ``power_z`` (standard normal, same shape), per angle of
        :data:`ANGLES` a ``<angle>_sign`` (+-1, [b, bs, 1, clusters])
        and a ``<angle>_comp`` (standard normal, [b, bs, ut, clusters]),
        ``xpr_z`` (standard normal, [b, bs, ut, clusters, rays]) and per
        angle a ``<angle>_perm`` (a permutation of the rays, [b, bs, 1,
        clusters, rays])."""
        sc = self._scenario
        dev, rdtype = sc.device, self.rdtype
        if generator is None:
            generator = config.generator(dev)
        shape = (sc.batch_size, sc.num_bs, sc.num_ut, sc.num_clusters_max)
        sign_shape = (sc.batch_size, sc.num_bs, 1, sc.num_clusters_max)
        perm_shape = sign_shape + (sc.rays_per_cluster,)

        def normal(s):
            return torch.randn(s, generator=generator, dtype=rdtype,
                               device=dev)

        u = torch.rand(shape, generator=generator, dtype=rdtype, device=dev)
        draws = {"delay_u": 1e-6 + (1.0 - 1e-6) * u,
                 "power_z": normal(shape)}
        for name in ANGLES:
            bits = torch.randint(0, 2, sign_shape, generator=generator,
                                 device=dev)
            draws[name + "_sign"] = (2 * bits - 1).to(rdtype)
            draws[name + "_comp"] = normal(shape)
        draws["xpr_z"] = normal(shape + (sc.rays_per_cluster,))
        for name in ANGLES:
            draws[name + "_perm"] = torch.argsort(normal(perm_shape), dim=-1)
        return draws

    def rays_from_draws(self, lsp, delay_u, power_z, xpr_z, **angle_draws):
        """The rays given an LSP realization and the draws of
        :meth:`draw`."""
        delays, delays_unscaled = self._cluster_delays(
            lsp.ds, lsp.k_factor, delay_u)
        powers, powers_for_angles = self._cluster_powers(
            lsp.ds, lsp.k_factor, delays_unscaled, power_z)
        angles = {}
        for name in ANGLES:
            sign = angle_draws[name + "_sign"]
            comp = angle_draws[name + "_comp"]
            if name in ("aoa", "aod"):
                spread = lsp.asa if name == "aoa" else lsp.asd
                a = self._azimuth_angles(spread, lsp.k_factor,
                                         powers_for_angles, name, sign,
                                         comp)
            else:
                spread = lsp.zsa if name == "zoa" else lsp.zsd
                a = self._zenith_angles(spread, lsp.k_factor,
                                        powers_for_angles, name, sign, comp)
            # step 8: random coupling of the rays
            perm = angle_draws[name + "_perm"].expand(a.shape)
            angles[name] = torch.gather(a, -1, perm) * (PI / 180.)
        xpr = self._cross_polarization_power_ratios(xpr_z)
        return Rays(delays=delays, powers=powers, xpr=xpr, **angles)

    def topology_updated_callback(self):
        """Recomputes the per-link cluster mask on the host and copies it
        to the scenario's device."""
        self._compute_clusters_mask()
        self._mask = torch.as_tensor(self._cluster_mask,
                                     device=self._scenario.device).to(
                                         self.rdtype)

    # ------------------------------------------------------------------
    # Internal utilities
    # ------------------------------------------------------------------
    def _param(self, name):
        return self._scenario.param_tensor(name).to(self.rdtype)

    def _compute_clusters_mask(self):
        """Mask [batch, num_bs, num_ut, num_clusters_max]; 1 marks a
        cluster unused by that link's state."""
        sc = self._scenario
        n_max = sc.num_clusters_max
        cl = np.arange(n_max)

        indoor = np.broadcast_to(sc.indoor[:, None, :, None],
                                 (sc.batch_size, sc.num_bs, sc.num_ut, 1))
        los = sc.los[..., None]
        nlos = ~los & ~indoor

        mask = np.zeros((sc.batch_size, sc.num_bs, sc.num_ut, n_max),
                        sc.np_rdtype)
        mask = np.where(indoor, (cl >= sc.num_clusters_indoor
                                 ).astype(sc.np_rdtype), mask)
        mask = np.where(los, (cl >= sc.num_clusters_los
                              ).astype(sc.np_rdtype), mask)
        mask = np.where(nlos, (cl >= sc.num_clusters_nlos
                               ).astype(sc.np_rdtype), mask)
        self._cluster_mask = mask

    def _cluster_delays(self, delay_spread, rician_k_factor, x):
        """Step 5, given the uniform draws ``x``."""
        sc = self._scenario
        mask = self._mask
        r_tau = self._param("rTau")[..., None]
        ds = delay_spread[..., None]

        unscaled = -r_tau * ds * torch.log(x)
        # unused clusters get a huge (1 s) delay so they sort to the end
        unscaled = unscaled * (1. - mask) + mask
        unscaled = unscaled - torch.amin(unscaled, dim=3, keepdim=True)
        unscaled = torch.sort(unscaled, dim=3).values

        # LoS scaling (7.5-3)
        k_db = 10. * torch.log10(rician_k_factor)
        c_tau = (0.7705 - 0.0433 * k_db + 0.0002 * k_db ** 2
                 + 0.000017 * k_db ** 3)[..., None]
        los = sc.tensor("los")[..., None]
        delays = torch.where(los, unscaled / c_tau, unscaled)
        return delays, unscaled

    def _cluster_powers(self, delay_spread, rician_k_factor,
                        unscaled_delays, z):
        """Step 6, given the normal draws ``z``."""
        sc = self._scenario
        mask = self._mask
        r_tau = self._param("rTau")[..., None]
        zeta = self._param("zeta")[..., None]
        ds = delay_spread[..., None]

        z = zeta * z
        powers = (torch.exp(-unscaled_delays * (r_tau - 1.)
                            / (r_tau * ds))
                  * torch.pow(10., -z / 10.))
        powers = powers * (1. - mask)
        powers = powers / torch.sum(powers, dim=3, keepdim=True)

        # LoS specular component (7.5-8): only used for angle generation
        k = rician_k_factor[..., None]
        p_scale = 1. / (k + 1.)
        p1_los = k * p_scale
        powers_1 = p_scale * powers[..., :1] + p1_los
        powers_n = p_scale * powers[..., 1:]
        los = sc.tensor("los")[..., None]
        powers_for_angles = torch.where(
            los, torch.cat([powers_1, powers_n], dim=3), powers)
        return powers, powers_for_angles

    def _ray_offsets(self, device):
        n_rays = self._scenario.rays_per_cluster
        return torch.as_tensor(_RAY_OFFSETS[:n_rays], device=device).to(
            self.rdtype)

    def _azimuth_angles(self, azimuth_spread, rician_k_factor,
                        cluster_powers, angle_type, sign, comp):
        """Step 7, azimuth [deg], given the signs and the normal draws
        of the random components."""
        sc = self._scenario
        asp = azimuth_spread[..., None]
        if angle_type == "aod":
            angles_los = sc.tensor("los_aod").to(self.rdtype)[..., None]
            c_spread = self._param("cASD")
        else:
            angles_los = sc.tensor("los_aoa").to(self.rdtype)[..., None]
            c_spread = self._param("cASA")
        c_spread = c_spread[..., None, None]

        k_db = 10. * torch.log10(rician_k_factor)[..., None]
        c_phi_nlos = self._param("CPhiNLoS")[..., None]
        c_phi_los = c_phi_nlos * (1.1035 - 0.028 * k_db
                                  - 0.002 * k_db ** 2
                                  + 0.0001 * k_db ** 3)
        los = sc.tensor("los")[..., None]
        c_phi = torch.where(los, c_phi_los, c_phi_nlos)

        # inverse Gaussian (7.5-9)
        z = cluster_powers / torch.amax(cluster_powers, dim=3, keepdim=True)
        z = torch.clamp(z, 1e-6, 1.)
        angles_prime = (2. * asp / 1.4) * torch.sqrt(-torch.log(z)) / c_phi

        comp = (asp / 7.0) * comp
        angles = sign * angles_prime + comp + angles_los
        # the first cluster at the LoS direction on LoS links
        angles = angles - torch.where(
            los, sign[..., :1] * angles_prime[..., :1] + comp[..., :1],
            torch.zeros((), dtype=self.rdtype, device=angles.device))

        # per-ray offsets (7.5-13)
        angles = angles[..., None] + c_spread * self._ray_offsets(
            angles.device)
        angles = torch.remainder(angles, 360.)
        return torch.where(angles > 180., angles - 360., angles)

    def _zenith_angles(self, zenith_spread, rician_k_factor,
                       cluster_powers, angle_type, sign, comp):
        """Step 7, zenith [deg], given the signs and the normal draws of
        the random components."""
        sc = self._scenario
        los = sc.tensor("los")
        indoor = sc.tensor("indoor")[:, None, :].expand(los.shape)
        los_uts = (los & ~indoor)[..., None]
        nlos_uts = (~los & ~indoor)[..., None]
        indoor_uts = indoor[..., None]

        zsp = zenith_spread[..., None]
        if angle_type == "zod":
            angles_los = sc.tensor("los_zod").to(self.rdtype)[..., None]
            # Table 7.5-6 note: cZSD = (3/8) 10^{mu_lgZSD}
            c_spread = (3. / 8.) * torch.pow(
                10., sc.tensor("lsp_log_mean")[..., 6].to(self.rdtype))
            c_spread = c_spread[..., None]
        else:
            angles_los = sc.tensor("los_zoa").to(self.rdtype)[..., None]
            c_spread = self._param("cZSA")[..., None]
        zod_offset = sc.tensor("zod_offset").to(self.rdtype)[..., None]

        k_db = 10. * torch.log10(rician_k_factor)[..., None]
        c_theta_nlos = self._param("CThetaNLoS")[..., None]
        c_theta_los = c_theta_nlos * (1.3086 + 0.0339 * k_db
                                      - 0.0077 * k_db ** 2
                                      + 0.0002 * k_db ** 3)
        c_theta = torch.where(los_uts, c_theta_los, c_theta_nlos)

        # inverse Laplacian (7.5-14)
        z = cluster_powers / torch.amax(cluster_powers, dim=3, keepdim=True)
        z = torch.clamp(z, 1e-6, 1.)
        angles_prime = -zsp * torch.log(z) / c_theta

        comp = (zsp / 7.0) * comp
        angles = sign * angles_prime + comp

        los_additional = -(sign[..., :1] * angles_prime[..., :1]
                           + comp[..., :1] - angles_los)
        zero = torch.zeros((), dtype=self.rdtype, device=angles.device)
        if angle_type == "zod":
            additional = torch.where(los_uts, los_additional,
                                     angles_los + zod_offset)
        else:
            additional = torch.where(los_uts, los_additional, zero)
            additional = torch.where(nlos_uts, angles_los, additional)
            additional = torch.where(indoor_uts, zero + 90., additional)
        angles = angles + additional

        angles = angles[..., None] + c_spread[..., None] * \
            self._ray_offsets(angles.device)
        angles = torch.remainder(angles, 360.)
        return torch.where(angles > 180., 360. - angles, angles)

    def _cross_polarization_power_ratios(self, x):
        """Step 9: per-ray XPR given the normal draws ``x``."""
        mu = self._param("muXPR")[..., None, None]
        std = self._param("sigmaXPR")[..., None, None]
        x = mu + std * x
        return torch.pow(10., x / 10.)
