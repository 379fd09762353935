"""System-level channel models: ``SystemLevelChannel`` and UMa, UMi and
RMa (counterpart of
``sionna_tpu/phy/channel/tr38901/system_level_channel.py``).

``set_topology`` runs on the host (the scenario's NumPy state, the
correlation Choleskys), copies what sampling reads to the scenario's
device once and, unless ``always_generate_lsp``, freezes one LSP draw
there. ``__call__`` draws the rays, the step-10 phases and the O2I
loss's normals from a ``torch.Generator`` and hands them to ``cir``,
which computes the CIR deterministically (the tests feed it the JAX
package's draws). Step 11 is ``ChannelCoefficientsGenerator``.
"""

import torch

from ..channel_model import ChannelModel
from ...config import config
from ...constants import PI
from .lsp import LSPGenerator
from .rays import Rays, RaysGenerator
from .channel_coefficients import Topology, ChannelCoefficientsGenerator
from .scenarios import UMaScenario, UMiScenario, RMaScenario

__all__ = ["SystemLevelChannel", "UMa", "UMi", "RMa"]


class SystemLevelChannel(ChannelModel):
    """Base class of the 3GPP system-level channel models.

    Call with ``(num_time_steps, sampling_frequency)`` (a leading
    ``batch_size``, fixed by the topology, is accepted and ignored) and
    optionally ``generator=``. Returns ``a`` [batch, num_rx, num_rx_ant,
    num_tx, num_tx_ant, num_paths, num_time_steps] complex path
    coefficients and ``tau`` [batch, num_rx, num_tx, num_paths] path
    delays [s], on the scenario's device.
    """

    def __init__(self, scenario, always_generate_lsp=False,
                 precision=None):
        super().__init__(precision=scenario.precision)
        self._scenario = scenario
        self._lsp_sampler = LSPGenerator(scenario)
        self._ray_sampler = RaysGenerator(scenario)
        self._set_topology_called = False
        self._return_rays = False
        self._always_generate_lsp = bool(always_generate_lsp)
        self._lsp = None

        if scenario.direction == "uplink":
            tx_array = scenario.ut_array
            rx_array = scenario.bs_array
        else:
            tx_array = scenario.bs_array
            rx_array = scenario.ut_array
        self._cir_sampler = ChannelCoefficientsGenerator(
            scenario.carrier_frequency, tx_array, rx_array,
            subclustering=True, precision=self.precision)

    @property
    def scenario(self):
        """The system-level scenario"""
        return self._scenario

    @property
    def return_rays(self):
        """If `True`, ``__call__`` also returns the sampled rays."""
        return self._return_rays

    @return_rays.setter
    def return_rays(self, value):
        if not isinstance(value, bool):
            raise TypeError("return_rays must be bool")
        self._return_rays = value

    def set_topology(self, ut_loc=None, bs_loc=None,
                     ut_orientations=None, bs_orientations=None,
                     ut_velocities=None, in_state=None, los=None,
                     bs_virtual_loc=None, generator=None):
        """Sets the network topology (see
        :meth:`SystemLevelScenario.set_topology`); the frozen LSP draw
        comes from ``generator``."""
        need_for_update = self._scenario.set_topology(
            ut_loc, bs_loc, ut_orientations, bs_orientations,
            ut_velocities, in_state, los, bs_virtual_loc)
        if need_for_update:
            self._lsp_sampler.topology_updated_callback()
            self._ray_sampler.topology_updated_callback()
            if not self._always_generate_lsp:
                self._lsp = self._lsp_sampler(generator=generator)
        self._set_topology_called = True
        return need_for_update

    def __call__(self, batch_size=None, num_time_steps=None,
                 sampling_frequency=None, generator=None):
        if not self._set_topology_called:
            raise RuntimeError("set_topology() must be called before "
                               "sampling the channel")
        if sampling_frequency is None:
            num_time_steps, sampling_frequency = (batch_size,
                                                  num_time_steps)
        sc = self._scenario
        if generator is None:
            generator = config.generator(sc.device)
        if self._always_generate_lsp:
            lsp = self._lsp_sampler(generator=generator)
        else:
            lsp = self._lsp
        rays = self._ray_sampler(lsp, generator=generator)
        # step 10: random phases [b, tx, rx, clusters, rays, 4]
        shape = (sc.batch_size, sc.num_bs, sc.num_ut, sc.num_clusters_max,
                 sc.rays_per_cluster, 4)
        if sc.direction == "uplink":
            shape = (shape[0], shape[2], shape[1]) + shape[3:]
        u = torch.rand(shape, generator=generator, dtype=self.rdtype,
                       device=sc.device)
        phi = u * (2 * PI) - PI
        pl_normal = torch.randn((sc.batch_size, sc.num_bs, sc.num_ut),
                                generator=generator, dtype=self.rdtype,
                                device=sc.device)
        return self.cir(num_time_steps, sampling_frequency, lsp, rays, phi,
                        pl_normal)

    def cir(self, num_time_steps, sampling_frequency, lsp, rays, phi,
            pl_normal):
        """The CIR (a, tau) given the LSPs, the rays of
        ``RaysGenerator`` (BS-to-UT order), the step-10 phases (in the
        link direction's order) and the O2I loss's normals."""
        sc = self._scenario
        to_rad = PI / 180.
        if sc.direction == "downlink":
            moving_end = "rx"
            tx_orientations = sc.tensor("bs_orientations")
            rx_orientations = sc.tensor("ut_orientations")
        else:
            moving_end = "tx"
            tx_orientations = sc.tensor("ut_orientations")
            rx_orientations = sc.tensor("bs_orientations")

        def rdt(name):
            return sc.tensor(name).to(self.rdtype)

        los_aoa = rdt("los_aoa") * to_rad
        los_aod = rdt("los_aod") * to_rad
        los_zoa = rdt("los_zoa") * to_rad
        los_zod = rdt("los_zod") * to_rad
        los = sc.tensor("los")
        distance_3d = rdt("distance_3d")
        c_ds = sc.param_tensor("cDS").to(self.rdtype) * 1e-9
        k_factor = lsp.k_factor
        sf = lsp.sf

        if sc.direction == "uplink":
            # swap TX and RX: BS <-> UT axes, departure <-> arrival
            def t(x):
                return x.transpose(1, 2)

            rays = Rays(delays=t(rays.delays), powers=t(rays.powers),
                        aoa=t(rays.aod), aod=t(rays.aoa),
                        zoa=t(rays.zod), zod=t(rays.zoa), xpr=t(rays.xpr))
            los_aoa, los_aod = t(los_aod), t(los_aoa)
            los_zoa, los_zod = t(los_zod), t(los_zoa)
            los = t(los)
            distance_3d = t(distance_3d)
            c_ds = t(c_ds)
            k_factor = t(k_factor)
            sf = t(sf)

        topology = Topology(
            velocities=rdt("ut_velocities"), moving_end=moving_end,
            los_aoa=los_aoa, los_aod=los_aod, los_zoa=los_zoa,
            los_zod=los_zod, los=los, distance_3d=distance_3d,
            tx_orientations=tx_orientations.to(self.rdtype),
            rx_orientations=rx_orientations.to(self.rdtype))

        t_samples = self._cir_sampler.sample_times(
            num_time_steps, sampling_frequency, sc.device)
        h, delays = self._cir_sampler._step_11(
            torch.as_tensor(phi).to(self.rdtype), topology, k_factor, rays,
            t_samples, c_ds)

        # step 12: pathloss and shadow fading
        h = self._step_12(h, sf, pl_normal)

        # [b, tx, rx, paths, rx_ant, tx_ant, time]
        # -> [b, rx, rx_ant, tx, tx_ant, paths, time]
        h = h.permute(0, 2, 4, 1, 5, 3, 6)
        delays = delays.permute(0, 2, 1, 3)
        if self._return_rays:
            return h, delays, rays
        return h, delays

    # ------------------------------------------------------------------
    # Internal utilities
    # ------------------------------------------------------------------
    def _step_12(self, h, sf, pl_normal):
        """Applies pathloss and shadow fading. The gain is float64 where
        the pathloss is (see ``LSPGenerator.pathloss_from_normal``), as
        in the JAX package, then cast to the complex dtype."""
        sc = self._scenario
        if sc.pathloss_enabled:
            pl_db = self._lsp_sampler.pathloss_from_normal(pl_normal)
            if sc.direction == "uplink":
                pl_db = pl_db.transpose(1, 2)
        else:
            pl_db = torch.zeros((), dtype=self.rdtype, device=h.device)
        if not sc.shadow_fading_enabled:
            sf = torch.ones_like(sf)
        gain = torch.pow(10., -pl_db / 20.) * torch.sqrt(sf)
        gain = gain.reshape(tuple(gain.shape)
                            + (1,) * (h.dim() - gain.dim()))
        return h * gain.to(self.cdtype)


class UMa(SystemLevelChannel):
    """Urban macrocell (UMa) channel model."""

    def __init__(self, carrier_frequency, o2i_model, ut_array, bs_array,
                 direction, enable_pathloss=True,
                 enable_shadow_fading=True, always_generate_lsp=False,
                 precision=None, device=None):
        scenario = UMaScenario(carrier_frequency, o2i_model, ut_array,
                               bs_array, direction, enable_pathloss,
                               enable_shadow_fading, precision=precision,
                               device=device)
        super().__init__(scenario, always_generate_lsp)


class UMi(SystemLevelChannel):
    """Urban microcell (UMi) channel model."""

    def __init__(self, carrier_frequency, o2i_model, ut_array, bs_array,
                 direction, enable_pathloss=True,
                 enable_shadow_fading=True, always_generate_lsp=False,
                 precision=None, device=None):
        scenario = UMiScenario(carrier_frequency, o2i_model, ut_array,
                               bs_array, direction, enable_pathloss,
                               enable_shadow_fading, precision=precision,
                               device=device)
        super().__init__(scenario, always_generate_lsp)


class RMa(SystemLevelChannel):
    """Rural macrocell (RMa) channel model."""

    def __init__(self, carrier_frequency, ut_array, bs_array, direction,
                 enable_pathloss=True, enable_shadow_fading=True,
                 average_street_width=20.0, average_building_height=5.0,
                 always_generate_lsp=False, precision=None, device=None):
        scenario = RMaScenario(carrier_frequency, ut_array, bs_array,
                               direction, enable_pathloss,
                               enable_shadow_fading, average_street_width,
                               average_building_height, precision=precision,
                               device=device)
        super().__init__(scenario, always_generate_lsp)
