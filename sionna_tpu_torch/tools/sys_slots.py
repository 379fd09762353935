"""The slot loops of BASELINE config 5 (the SYS multi-cell simulation)
on the port's blocks, as ``chip_smoke.py`` phases 20 and 21 drive them.

- :class:`MulticellSlots` is ``bench.bench_sys`` (``bench.py:414-484``):
  a hexagonal grid of UMi sectors, a distance-proxy SINR faded by an
  exponential draw per slot, OLLA (functional ``step``) over the PHY
  abstraction, the HARQ feedback fed back. One slot is eager tensor code
  on the card that reads nothing back.
- :class:`DownlinkSlots` composes the TR 38.901 UMi channel with the SYS
  blocks, as the upstream SYS tutorial does. Per slot: the channel
  (``UMi`` over 14 OFDM symbols), ``cir_to_ofdm_channel``,
  ``get_pathloss``; the PF scheduler per sector on the achievable rate
  log2(1 + SNR) of each UT's serving link at full power spread
  uniformly (interference from the other sectors at full power);
  ``downlink_fair_power_control`` per sector and OFDM symbol on the
  scheduled UTs; ``spread_across_subcarriers``; the per-RE SINR through
  ``CBFPrecodedChannel`` and ``LMMSEPostEqualizationSINR`` with every
  sector's streams as interference; OLLA (last slot's HARQ and effective
  SINR) chooses the MCS, ``EESM`` and the PHY abstraction give the HARQ
  outcome and decoded bits, which go back to OLLA and to the
  scheduler's past rate. Each UT is served by the sector it was dropped
  in (``StreamManagement``: one stream per UT, ``num_ut_per_sector``
  streams per sector). The scheduler runs first in a slot because power
  control and spreading need its allocation. With one antenna per
  sector a stream's precoder is a unit phase whatever the rule: the
  upstream tutorial's RZF would factor each sector's Gram matrix of 10
  streams over one antenna, rank one plus the noise power, which float32
  cannot hold positive definite when a UT's gain is large (the Cholesky
  fails), so conjugate beamforming gives the same SINR here.

Both take the same blocks of the JAX package (``tests/test_torch_sys.py``
composes them there at a small size).
"""

import numpy as np
import torch

from ..phy.channel import cir_to_ofdm_channel, subcarrier_frequencies
from ..phy.channel.tr38901 import UMi, PanelArray
from ..phy.mimo import StreamManagement
from ..phy.ofdm import (CBFPrecodedChannel, LMMSEPostEqualizationSINR,
                        ResourceGrid)
from ..phy.utils import dbm_to_watt
from ..sys import (EESM, OuterLoopLinkAdaptation, PFSchedulerSUMIMO,
                   PHYAbstraction, downlink_fair_power_control,
                   gen_hexgrid_topology, get_pathloss,
                   spread_across_subcarriers)

# thermal noise density and a UT noise figure (TR 38.901 Table 7.8-1)
NOISE_DBM_PER_HZ = -174.
UT_NOISE_FIGURE_DB = 9.
# the UMi BS's transmit power over 20 MHz (TR 38.901 Table 7.8-1)
UMI_BS_POWER_DBM = 44.
CARRIER_FREQUENCY = 3.5e9
# bench_sys's link adaptation and allocation
BLER_TARGET = 0.1
NUM_RE = 1000
# the downlink grid: one slot of 14 OFDM symbols at 30 kHz; PDSCH
# (MCS category 1) with MCS table 1
NUM_OFDM_SYMBOLS = 14
SUBCARRIER_SPACING = 30e3
MCS_TABLE_INDEX = 1
MCS_CATEGORY = 1


def distance_proxy_sinr(ut_loc, bs_loc):
    """``bench.bench_sys``'s SINR per UT from the first drop:
    (interfering distance sum / serving distance)^2 / num_bs (NumPy
    float64)."""
    d = np.linalg.norm(np.asarray(ut_loc)[0][:, None]
                       - np.asarray(bs_loc)[0][None], axis=-1)
    serving = d.min(axis=1)
    interf = d.sum(axis=1) - serving
    return (interf / serving) ** 2 / bs_loc.shape[1]


class MulticellSlots:
    """``bench.bench_sys`` on the port: the topology from
    ``config.np_rng``, a ``PHYAbstraction`` and an OLLA on ``device``."""

    def __init__(self, num_ut_per_sector=4, device=None):
        self.topology = gen_hexgrid_topology(
            batch_size=1, num_rings=1,
            num_ut_per_sector=num_ut_per_sector, scenario="umi")
        ut_loc, bs_loc = self.topology[:2]
        self.num_ut = ut_loc.shape[1]
        self.phy_abs = PHYAbstraction(device=device)
        dev = self.phy_abs.device
        self.sinr_base = torch.as_tensor(
            distance_proxy_sinr(ut_loc, bs_loc), device=dev).float()
        self.olla = OuterLoopLinkAdaptation(self.phy_abs, self.num_ut,
                                            bler_target=BLER_TARGET)
        self.n_re = torch.full((self.num_ut,), NUM_RE, dtype=torch.int32,
                               device=dev)

    def slot(self, state, harq, fading, generator=None, uniform=None):
        """One slot given the fading draw (exponential, [num_ut]):
        returns (state, harq, decoded bits, MCS)."""
        sinr_eff = self.sinr_base * fading
        state, mcs = self.olla.step(state, self.n_re, harq_feedback=harq,
                                    sinr_eff=sinr_eff)
        bits, harq, *_ = self.phy_abs(mcs, sinr_eff=sinr_eff,
                                      num_allocated_re=self.n_re,
                                      generator=generator, uniform=uniform)
        return state, harq, bits, mcs

    def run(self, state, n_slots, generator):
        """``n_slots`` slots from HARQ "N/A", as one call of
        ``bench_sys``'s loop: (state, decoded bits, NACKs), the sums on
        the device."""
        dev = self.n_re.device
        harq = torch.full((self.num_ut,), -1, dtype=torch.int32, device=dev)
        bits = torch.zeros((), dtype=torch.int64, device=dev)
        nacks = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_slots):
            fading = torch.empty(self.num_ut, device=dev).exponential_(
                generator=generator)
            state, harq, b, _ = self.slot(state, harq, fading,
                                          generator=generator)
            bits += b.sum()
            nacks += (harq == 0).sum()
        return state, bits, nacks


def omni_array():
    """The single V-polarized omnidirectional element of
    ``tests/test_sys.py:353-364``."""
    return PanelArray(num_rows_per_panel=1, num_cols_per_panel=1,
                      polarization="single", polarization_type="V",
                      antenna_pattern="omni",
                      carrier_frequency=CARRIER_FREQUENCY)


class DownlinkSlots:
    """The UMi downlink slot chain of the module docstring over a
    topology from :func:`gen_hexgrid_topology` (or ``topology``, any
    drop whose UTs come ``num_ut_per_sector`` per sector in sector
    order, as ``gen_hexgrid_topology`` orders them).

    ``STAGES`` names the stages that ``slot`` can time."""

    STAGES = ("channel", "cir_to_ofdm", "pathloss", "scheduler",
              "power_control", "spread", "sinr", "olla", "eesm", "phy_abs")

    def __init__(self, num_ut_per_sector=10, num_subcarriers=612,
                 topology=None, generator=None, device=None):
        if topology is None:
            topology = gen_hexgrid_topology(
                batch_size=1, num_rings=1,
                num_ut_per_sector=num_ut_per_sector, scenario="umi")
        self.topology = topology
        num_ut, num_bs = topology[0].shape[1], topology[1].shape[1]
        self.num_ut, self.num_bs = num_ut, num_bs
        self.upt = num_ut_per_sector
        self.num_sym, self.num_sc = NUM_OFDM_SYMBOLS, num_subcarriers
        self.scs = SUBCARRIER_SPACING
        self.channel = UMi(CARRIER_FREQUENCY, "low", omni_array(),
                           omni_array(), "downlink", device=device)
        dev = self.channel.scenario.device
        self.device = dev
        self.channel.set_topology(*topology, generator=generator)
        self.freqs = subcarrier_frequencies(num_subcarriers, self.scs,
                                            device=dev)
        # each UT served by the sector it was dropped in
        serving = np.arange(num_ut) // num_ut_per_sector
        self.association = np.zeros((num_ut, num_bs), np.int64)
        self.association[np.arange(num_ut), serving] = 1
        self.serving = torch.as_tensor(serving, device=dev)
        rg = ResourceGrid(self.num_sym, num_subcarriers, self.scs,
                          num_tx=num_bs, num_streams_per_tx=num_ut_per_sector)
        sm = StreamManagement(self.association, num_ut_per_sector)
        self.precoded = CBFPrecodedChannel(rg, sm, device=dev)
        self.posteq = LMMSEPostEqualizationSINR(rg, sm, device=dev)
        # noise power per RE and the BS power per RE at full load [W]
        self.no = float(dbm_to_watt(NOISE_DBM_PER_HZ + UT_NOISE_FIGURE_DB
                                    + 10 * np.log10(self.scs),
                                    precision="double"))
        self.p_re = float(dbm_to_watt(UMI_BS_POWER_DBM, precision="double")
                          ) / num_subcarriers
        self.scheduler = PFSchedulerSUMIMO(
            num_ut_per_sector, num_subcarriers, self.num_sym,
            batch_size=[1, num_bs], device=dev)
        self.eesm = EESM(device=dev)
        self.phy_abs = PHYAbstraction(device=dev)
        self.olla = OuterLoopLinkAdaptation(
            self.phy_abs, num_ut, batch_size=1, bler_target=BLER_TARGET)

    def init_state(self):
        """(OLLA state, HARQ, last effective SINR, last rate) before the
        first slot."""
        dev = self.device
        return (self.olla.init_state(),
                torch.full((1, self.num_ut), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((1, self.num_ut), device=dev),
                torch.zeros((1, self.num_bs, self.upt), device=dev))

    def link_gain_db(self, generator, redraw_lsp=False):
        """The gain [dB] of every link [1, num_ut, num_bs]: the mean of
        |h|^2 over the symbols and subcarriers of one channel draw from
        ``generator``, after a new draw of the frozen LSPs if
        ``redraw_lsp`` (as each repetition of ``tools/sys_ref.py --part
        gain`` draws them)."""
        if redraw_lsp:
            self.channel._lsp = self.channel._lsp_sampler(
                generator=generator)
        a, tau = self.channel(self.num_sym, self.scs, generator=generator)
        h = cir_to_ofdm_channel(self.freqs, a, tau)
        return 10 * torch.log10(torch.mean(h.abs() ** 2, dim=(2, 4, 5, 6)))

    def per_sector(self, x):
        """[1, num_ut, ...] -> [1, num_bs, num_ut_per_sector, ...]"""
        return x.reshape((1, self.num_bs, self.upt) + tuple(x.shape[2:]))

    def slot(self, state, h=None, generator=None, uniform=None,
             mark=None):
        """One slot from ``state`` (see :meth:`init_state`), on the
        channel's frequency response ``h`` [1, num_ut, 1, num_bs, 1,
        sym, sc] (default: drawn from ``generator``). ``mark(name)``, if
        given, is called after each stage of ``STAGES``. Returns (state,
        outputs): the decoded bits, HARQ, MCS, effective SINR [1,
        num_ut], the per-RE SINR [1, sym, sc, num_ut, 1] and the
        schedule [1, num_bs, sym, sc, num_ut_per_sector, 1]."""
        mark = mark or (lambda name: None)
        olla_state, harq, sinr_eff_last, rate_last = state
        if h is None:
            a, tau = self.channel(self.num_sym, self.scs,
                                  generator=generator)
            mark("channel")
            h = cir_to_ofdm_channel(self.freqs, a, tau)
            mark("cir_to_ofdm")
        else:
            mark("channel")
            mark("cir_to_ofdm")
        pl_all, pl_serv = get_pathloss(h, self.association)
        mark("pathloss")

        # achievable rate of each UT's serving link at full power
        h2 = torch.abs(h[:, :, 0, :, 0]) ** 2          # [1, ut, bs, sym, sc]
        idx = self.serving[None, :, None, None, None].expand(
            (1, self.num_ut, 1) + tuple(h2.shape[3:]))
        h2_serv = torch.gather(h2, 2, idx)[:, :, 0]     # [1, ut, sym, sc]
        gain = 1. / pl_all                              # [1, ut, bs, sym]
        gain_serv = 1. / pl_serv                        # [1, ut, sym]
        ipn = self.no + self.p_re * (gain.sum(dim=2) - gain_serv)
        rate = torch.log2(1. + h2_serv * self.p_re / ipn[..., None])
        # [1, bs, sym, sc, ut per sector]
        rate = self.per_sector(rate).permute(0, 1, 3, 4, 2)
        is_scheduled = self.scheduler(rate_last, rate)
        mark("scheduler")

        # per sector and OFDM symbol: [1, bs, sym, ut per sector]
        n_sc = is_scheduled[..., 0].sum(dim=-2)
        pl_sec = self.per_sector(pl_serv).permute(0, 1, 3, 2)
        ipn_sec = self.per_sector(ipn).permute(0, 1, 3, 2)
        tx_power, _ = downlink_fair_power_control(
            pl_sec, ipn_sec, n_sc, bs_max_power_dbm=UMI_BS_POWER_DBM)
        mark("power_control")
        tx_power = spread_across_subcarriers(tx_power, is_scheduled,
                                             num_tx=1)
        tx_power = tx_power.reshape(1, self.num_bs, self.upt, self.num_sym,
                                    self.num_sc)
        mark("spread")

        h_eff = self.precoded(h, tx_power)
        sinr = self.posteq(h_eff, self.no)   # [1, sym, sc, ut, 1]
        mark("sinr")

        n_re = is_scheduled.sum(dim=(2, 3, 5)).reshape(1, self.num_ut)
        olla_state, mcs = self.olla.step(
            olla_state, n_re, harq_feedback=harq, sinr_eff=sinr_eff_last,
            mcs_table_index=MCS_TABLE_INDEX, mcs_category=MCS_CATEGORY)
        mark("olla")
        sinr_eff = self.eesm(sinr, mcs, mcs_table_index=MCS_TABLE_INDEX)
        mark("eesm")
        bits, harq, *_ = self.phy_abs(
            mcs, sinr_eff=sinr_eff, num_allocated_re=n_re,
            mcs_table_index=MCS_TABLE_INDEX, mcs_category=MCS_CATEGORY,
            generator=generator, uniform=uniform)
        mark("phy_abs")
        rate_last = self.per_sector(bits).to(sinr_eff.dtype) / (
            self.num_sym * self.num_sc)
        state = (olla_state, harq, sinr_eff, rate_last)
        return state, dict(bits=bits, harq=harq, mcs=mcs, sinr_eff=sinr_eff,
                           sinr=sinr, is_scheduled=is_scheduled)
