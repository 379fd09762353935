"""System-level (SYS) package (counterpart of ``sionna_tpu.sys``)."""

from .effective_sinr import EffectiveSINR, EESM
from .phy_abstraction import PHYAbstraction
from .link_adaptation import (InnerLoopLinkAdaptation,
                              OuterLoopLinkAdaptation)
from .power_control import (open_loop_uplink_power_control,
                            downlink_fair_power_control)
from .scheduling import PFSchedulerSUMIMO
from .topology import (HexGrid, Hexagon, gen_hexgrid_topology,
                       get_num_hex_in_grid, convert_hex_coord)
from .utils import (get_pathloss, is_scheduled_in_slot,
                    spread_across_subcarriers)
