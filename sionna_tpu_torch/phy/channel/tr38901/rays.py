"""Rays container of TR 38.901 (counterpart of the ``Rays`` class of
``sionna_tpu/phy/channel/tr38901/rays.py``; its ``RaysGenerator`` comes
with the system-level models, ROADMAP.md queue 1 item 18)."""

from ...block import Object

__all__ = ["Rays"]


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
