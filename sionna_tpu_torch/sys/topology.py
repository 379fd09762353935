"""Multicell hexagonal-grid topology with wraparound (counterpart of
``sionna_tpu/sys/topology.py``): host NumPy drawing from
``config.np_rng`` with the JAX package's calls in its order, so that one
seed gives both packages the same topology."""

import numpy as np

from ..phy.block import Object
from ..phy.config import config
from ..phy.constants import PI
from ..phy.channel.utils import (set_3gpp_scenario_parameters,
                                 random_ut_properties)

__all__ = ["get_num_hex_in_grid", "convert_hex_coord", "Hexagon",
           "HexGrid", "gen_hexgrid_topology"]


def get_num_hex_in_grid(num_rings):
    """Number of hexagons in a spiral grid with ``num_rings`` rings:
    1 + 3N(N+1)."""
    return 1 + 3 * num_rings * (num_rings + 1)


def convert_hex_coord(coord, conversion_type, hex_radius=None,
                      precision=None):
    """Converts hexagon-center coordinates between 'offset', 'axial'
    and 'euclid' types."""
    valid = ["offset2euclid", "euclid2offset", "euclid2axial",
             "offset2axial", "axial2offset", "axial2euclid"]
    if conversion_type not in valid:
        raise ValueError(f"conversion_type must be one of {valid}")

    coord = np.asarray(coord)
    if conversion_type.startswith("euclid"):
        coord = coord.astype(np.float64)
    else:
        coord = coord.astype(np.int64)

    if conversion_type in ("offset2euclid", "euclid2offset",
                           "euclid2axial", "axial2euclid") \
            and hex_radius is None:
        raise ValueError(f"hex_radius must be specified for "
                         f"{conversion_type}")
    if hex_radius is not None:
        hex_radius = np.asarray(hex_radius, np.float64)
        dist_x = hex_radius * 1.5
        dist_y = hex_radius * np.sqrt(3.)

    if conversion_type == "offset2euclid":
        col, row = coord[..., 0], coord[..., 1]
        x = col * dist_x
        y = row * dist_y + (col % 2) * dist_y / 2
        return np.stack([x, y], axis=-1)
    if conversion_type == "euclid2offset":
        x, y = coord[..., 0], coord[..., 1]
        col = np.asarray(x / dist_x)
        row = np.asarray((y - (col.astype(np.int64) % 2) * dist_y / 2)
                         / dist_y)
        return np.stack([np.rint(col), np.rint(row)],
                        axis=-1).astype(np.int64)
    if conversion_type == "offset2axial":
        col, row = coord[..., 0], coord[..., 1]
        q = col
        r = row - (col - (col % 2)) // 2
        return np.stack([q, r], axis=-1)
    if conversion_type == "axial2offset":
        q, r = coord[..., 0], coord[..., 1]
        col = q
        row = r + (q - (q % 2)) // 2
        return np.stack([col, row], axis=-1)
    if conversion_type == "euclid2axial":
        off = convert_hex_coord(coord, "euclid2offset",
                                hex_radius=hex_radius)
        return convert_hex_coord(off, "offset2axial")
    # axial2euclid
    off = convert_hex_coord(coord, "axial2offset")
    return convert_hex_coord(off, "offset2euclid",
                             hex_radius=hex_radius)


class Hexagon(Object):
    """A hexagon in a hexagonal grid."""

    _NEIGHBOR_AXIAL_DIRECTIONS = np.array(
        [[1, 0], [1, -1], [0, -1], [-1, 0], [-1, 1], [0, 1]])

    def __init__(self, radius, coord, coord_type="offset",
                 precision=None):
        super().__init__(precision=precision)
        self._coord_offset = None
        self._radius = float(radius)
        if coord_type not in ("offset", "axial", "euclid"):
            raise ValueError("Invalid input value for coord_type")
        if coord_type == "offset":
            self.coord_offset = coord
        elif coord_type == "axial":
            self.coord_axial = coord
        else:
            self.coord_euclid = coord

    @property
    def coord_offset(self):
        """[2] offset coordinates within the grid"""
        return self._coord_offset

    @coord_offset.setter
    def coord_offset(self, value):
        self._coord_offset = np.asarray(value, np.int64)
        self._coord_axial = convert_hex_coord(self._coord_offset,
                                              "offset2axial")
        self._coord_euclid = convert_hex_coord(
            self._coord_offset, "offset2euclid",
            hex_radius=self._radius)

    @property
    def coord_axial(self):
        """[2] axial coordinates within the grid"""
        return self._coord_axial

    @coord_axial.setter
    def coord_axial(self, value):
        self._coord_axial = np.asarray(value, np.int64)
        self._coord_offset = convert_hex_coord(self._coord_axial,
                                               "axial2offset")
        self._coord_euclid = convert_hex_coord(
            self._coord_offset, "offset2euclid",
            hex_radius=self._radius)

    @property
    def coord_euclid(self):
        """[2] Euclidean center coordinates [m]"""
        return self._coord_euclid

    @coord_euclid.setter
    def coord_euclid(self, value):
        self._coord_offset = convert_hex_coord(
            np.asarray(value, np.float64), "euclid2offset",
            hex_radius=self._radius)
        self._coord_euclid = convert_hex_coord(
            self._coord_offset, "offset2euclid",
            hex_radius=self._radius)
        self._coord_axial = convert_hex_coord(self._coord_offset,
                                              "offset2axial")

    @property
    def radius(self):
        """Distance from center to any corner"""
        return self._radius

    @radius.setter
    def radius(self, value):
        self._radius = float(value)
        if self._coord_offset is not None:
            self._coord_euclid = convert_hex_coord(
                self._coord_offset, "offset2euclid",
                hex_radius=self._radius)

    def corners(self):
        """[6, 2] Euclidean corner coordinates"""
        ang = np.arange(6) * PI / 3
        corners = np.stack([self._radius * np.cos(ang),
                            self._radius * np.sin(ang)], axis=1)
        return self._coord_euclid[None] + corners

    def neighbor(self, axial_direction_idx):
        """Neighboring hexagon along one of 6 axial directions"""
        d = self._NEIGHBOR_AXIAL_DIRECTIONS[axial_direction_idx]
        return Hexagon(self._radius, self._coord_axial + d,
                       coord_type="axial", precision=self.precision)

    def coord_dict(self):
        """{'euclid','offset','axial'} coordinates"""
        return {"euclid": self._coord_euclid,
                "offset": self._coord_offset,
                "axial": self._coord_axial}


class HexGrid(Object):
    """Spiral hexagonal grid with random UT drops and wraparound. A drop
    is host NumPy, as in the JAX package: the grid holds no tensors.

    Call: (batch_size, num_ut_per_sector, min_bs_ut_dist,
    max_bs_ut_dist=None, min_ut_height=0, max_ut_height=0) ->
    (ut_loc [b, cells, 3, upt, 3],
    mirror_cell_per_ut_loc [..., cells, 3],
    wraparound_dist [..., cells])."""

    def __init__(self, num_rings, cell_radius=None, cell_height=0.,
                 isd=None, center_loc=(0, 0),
                 center_loc_type="offset", precision=None):
        super().__init__(precision=precision)
        if (cell_radius is None) == (isd is None):
            raise ValueError("Exactly one of {'cell_radius', 'isd'} "
                             "must be provided as input")
        if isd is not None:
            cell_radius = float(isd) / np.sqrt(3.)
        self._cell_radius = float(cell_radius)
        self._isd = self._cell_radius * np.sqrt(3.)
        self._cell_height = float(cell_height)
        self._center_loc = center_loc
        self._center_loc_type = center_loc_type
        if num_rings < 1:
            raise ValueError("The number of rings must be positive")
        self._num_rings = int(num_rings)
        self._compute_grid()
        self._get_mirror_displacements()
        self._get_mirror_cell_loc()

    @property
    def grid(self):
        """dict: spiral index -> Hexagon"""
        return self._grid

    @property
    def cell_loc(self):
        """[num_cells, 3] Euclidean cell centers"""
        loc = np.stack([c.coord_euclid for c in self._grid.values()])
        z = np.full((loc.shape[0], 1), self._cell_height)
        return np.concatenate([loc, z], axis=-1).astype(self.np_rdtype)

    @property
    def num_rings(self):
        return self._num_rings

    @property
    def num_cells(self):
        return len(self._grid)

    @property
    def cell_radius(self):
        return self._cell_radius

    @property
    def isd(self):
        """Inter-site distance = sqrt(3) * cell_radius"""
        return self._isd

    @property
    def cell_height(self):
        return self._cell_height

    @property
    def mirror_cell_loc(self):
        """[num_cells, 7, 3] base + 6 mirror centers per cell"""
        return self._mirror_cell_loc

    def _get_mirror_displacements(self):
        """Offset/Euclidean displacements of the 6 mirror grids."""
        n = self._num_rings
        odd = n & 1
        self._mirror_displacements_offset = np.array(
            [[0, 0],
             [2 * n + 1, 0],
             [n, int(3 * n / 2 + 1 - .5 * odd)],
             [-n - 1, int(3 * n / 2 + .5 * odd)],
             [-(2 * n + 1), -1],
             [-n, -int(3 * n / 2 + .5 * odd + 1)],
             [n + 1, -int(3 * n / 2 + 1 - .5 * odd)]])
        self._mirror_displacements_euclid = convert_hex_coord(
            self._mirror_displacements_offset, "offset2euclid",
            hex_radius=self._cell_radius)

    def _get_mirror_cell_loc(self):
        disp3d = np.concatenate(
            [self._mirror_displacements_euclid, np.zeros((7, 1))],
            axis=-1)
        self._mirror_cell_loc = (self.cell_loc[:, None, :]
                                 + disp3d[None]).astype(self.np_rdtype)

    def _compute_grid(self):
        """Builds the spiral grid."""
        self._grid = {0: Hexagon(self._cell_radius,
                                 coord=self._center_loc,
                                 coord_type=self._center_loc_type,
                                 precision=self.precision)}
        center_axial = self._grid[0].coord_axial
        hex_key = 1
        for ring_radius in range(1, self._num_rings + 1):
            hex_curr = Hexagon(
                self._cell_radius,
                coord=(-ring_radius + center_axial[0],
                       ring_radius + center_axial[1]),
                coord_type="axial", precision=self.precision)
            for ii in range(6):
                for _ in range(ring_radius):
                    self._grid[hex_key] = hex_curr
                    hex_curr = hex_curr.neighbor(axial_direction_idx=ii)
                    hex_key += 1

    def __call__(self, batch_size, num_ut_per_sector, min_bs_ut_dist,
                 max_bs_ut_dist=None, min_ut_height=0., max_ut_height=0.):
        rng = config.np_rng
        min_ut_height = float(min_ut_height)
        max_ut_height = float(max_ut_height)
        if max_ut_height < min_ut_height:
            raise ValueError("max_ut_height must be >= min_ut_height")
        min_bs_ut_dist = float(min_bs_ut_dist)
        max_bs_ut_dist = self._cell_radius if max_bs_ut_dist is None \
            else float(max_bs_ut_dist)
        if min_bs_ut_dist > max_bs_ut_dist:
            raise ValueError(
                "min_bs_ut_dist must not exceed max_bs_ut_dist")

        h = self._cell_height
        if min_ut_height <= h <= max_ut_height:
            dz_min = 0.
        else:
            dz_min = min(abs(h - min_ut_height), abs(h - max_ut_height))
        dz_max = max(abs(h - min_ut_height), abs(h - max_ut_height))

        min_bs_ut_dist = max(min_bs_ut_dist, dz_min)
        r_min2 = min_bs_ut_dist ** 2 - dz_min ** 2
        r_max2 = max_bs_ut_dist ** 2 - dz_max ** 2
        if np.sqrt(r_min2) > self._isd / 2:
            raise ValueError("The minimum BS-UT distance cannot be "
                             "larger than half the inter-site distance")

        shape = (batch_size, self.num_cells, 3, num_ut_per_sector)
        alpha_half = rng.uniform(-PI / 6., PI / 6., shape)
        r_max = self._isd / (2 * np.cos(alpha_half))
        r_max = np.minimum(r_max, np.sqrt(r_max2))
        distance = np.sqrt(rng.uniform(size=shape)
                           * (r_max ** 2 - r_min2) + r_min2)
        side = rng.integers(0, 2, shape) * 2. + 1.
        alpha = alpha_half + side * PI / 6.
        alpha = alpha + np.array([0, 2 * PI / 3, 4 * PI / 3]
                                 )[None, None, :, None]

        cell_loc = self.cell_loc  # [num_cells, 3]
        ut_loc = np.stack([distance * np.cos(alpha),
                           distance * np.sin(alpha)], axis=-1)
        ut_loc = ut_loc + cell_loc[None, :, None, None, :2]
        ut_loc_z = rng.uniform(min_ut_height, max_ut_height + 1e-12,
                               shape + (1,))
        ut_loc = np.concatenate([ut_loc, ut_loc_z],
                                axis=-1).astype(self.np_rdtype)

        # Wraparound: nearest of {base + 6 mirror} centers per cell
        # [b, cells, 3, upt, 1, 1, 3] - [cells, 7, 3]
        diff = (ut_loc[:, :, :, :, None, None, :]
                - self._mirror_cell_loc[None, None, None, None])
        dist = np.linalg.norm(diff, axis=-1)  # [..., cells, 7]
        wraparound_dist = dist.min(axis=-1).astype(self.np_rdtype)
        idx = dist.argmin(axis=-1)  # [..., cells]
        mirror_cell_per_ut_loc = np.take_along_axis(
            np.broadcast_to(self._mirror_cell_loc,
                            idx.shape + (7, 3)),
            idx[..., None, None], axis=-2)[..., 0, :]
        return ut_loc, mirror_cell_per_ut_loc, wraparound_dist


def gen_hexgrid_topology(batch_size, num_rings, num_ut_per_sector,
                         scenario, min_bs_ut_dist=None,
                         max_bs_ut_dist=None, isd=None, bs_height=None,
                         min_ut_height=None, max_ut_height=None,
                         indoor_probability=None, min_ut_velocity=None,
                         max_ut_velocity=None,
                         downtilt_to_sector_center=True, los=None,
                         return_grid=False, precision=None):
    """Generates a multicell hexagonal-grid topology (3 sectors/BSs
    per cell, wraparound virtual BS positions) ready for
    ``set_topology``.

    Returns (ut_loc, bs_loc, ut_orientations, bs_orientations,
    ut_velocities, in_state, los, bs_virtual_loc[, grid])."""
    (min_bs_ut_dist, isd, bs_height, min_ut_height, max_ut_height,
     indoor_probability, min_ut_velocity, max_ut_velocity) = \
        set_3gpp_scenario_parameters(
            scenario, min_bs_ut_dist, isd, bs_height, min_ut_height,
            max_ut_height, indoor_probability, min_ut_velocity,
            max_ut_velocity, precision)
    rdtype = np.float64 if (precision or config.precision) == "double" \
        else np.float32

    grid = HexGrid(isd=isd, cell_height=bs_height, num_rings=num_rings,
                   precision=precision)
    num_cells = grid.num_cells

    # 3 co-located BSs (sectors) per cell
    bs_loc = np.repeat(grid.cell_loc, 3, axis=0)
    bs_loc = np.broadcast_to(bs_loc, (batch_size,) + bs_loc.shape
                             ).astype(rdtype)

    bs_yaw = np.tile([PI / 3.0, PI, 5.0 * PI / 3.0], num_cells)
    if downtilt_to_sector_center:
        sector_center = (min_bs_ut_dist + 0.5 * isd) * 0.5
        bs_downtilt = 0.5 * PI - np.arctan(sector_center / bs_height)
    else:
        bs_downtilt = 0.
    bs_orientations = np.stack(
        [bs_yaw, np.full_like(bs_yaw, bs_downtilt),
         np.zeros_like(bs_yaw)], axis=-1)
    bs_orientations = np.broadcast_to(
        bs_orientations, (batch_size,) + bs_orientations.shape
    ).astype(rdtype)

    # Drop UTs and compute wraparound mirror BS locations
    ut_loc, bs_virtual_loc, _ = grid(
        batch_size, num_ut_per_sector, min_bs_ut_dist,
        max_bs_ut_dist=max_bs_ut_dist, min_ut_height=min_ut_height,
        max_ut_height=max_ut_height)
    # [b, num_ut, 3]
    ut_loc = ut_loc.reshape(batch_size, -1, 3)
    num_ut = ut_loc.shape[1]
    # [b, num_ut, num_cells, 3] -> [b, num_cells*3, num_ut, 3]
    bs_virtual_loc = bs_virtual_loc.reshape(batch_size, num_ut,
                                            num_cells, 3)
    bs_virtual_loc = np.repeat(bs_virtual_loc, 3, axis=2)
    bs_virtual_loc = np.transpose(bs_virtual_loc, (0, 2, 1, 3))

    ut_orientations, ut_velocities, in_state = random_ut_properties(
        batch_size, num_ut, indoor_probability, min_ut_velocity,
        max_ut_velocity, precision)

    out = (ut_loc, bs_loc, ut_orientations, bs_orientations,
           ut_velocities, in_state, los, bs_virtual_loc)
    if return_grid:
        return out + (grid,)
    return out
