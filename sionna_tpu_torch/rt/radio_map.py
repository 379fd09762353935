"""Radio map (coverage map) solver (API parity with
sionna.rt.RadioMapSolver / RadioMap).

PyTorch counterpart of ``sionna_tpu/rt/radio_map.py``. The
measurement-plane cells are treated as a batch of isotropic
single-antenna receivers and evaluated with the same image-method engine
as the path solver, one batched computation over [num_sequences, num_tx,
num_cells] on the solver's device. The cell grid is built on the host,
and ``sample_positions`` reads the map back to the host to draw from it
with NumPy."""

import numpy as np
import torch

from .antenna_array import PlanarArray
from .geometry import resolve_device
from .scene import Receiver
from .solver import PathSolver

__all__ = ["RadioMapSolver", "RadioMap"]


class RadioMap:
    """Coverage map over a rectangular measurement grid.

    path_gain / rss: [num_tx, num_cells_y, num_cells_x] and sinr:
    [num_cells_y, num_cells_x], tensors on the solver's device;
    cell_centers: [num_cells_y, num_cells_x, 3] host NumPy."""

    def __init__(self, path_gain, cell_centers, tx_powers_dbm,
                 noise_power_w=1e-13, tx_positions=None):
        self.path_gain = path_gain
        self.cell_centers = cell_centers
        self._tx_powers_dbm = np.asarray(tx_powers_dbm)
        self._noise_power_w = float(noise_power_w)
        self._tx_positions = (None if tx_positions is None
                              else np.asarray(tx_positions))

    @property
    def rss(self):
        """Received signal strength [W] per cell and TX"""
        p_w = torch.as_tensor(10. ** ((self._tx_powers_dbm - 30.) / 10.),
                              dtype=self.path_gain.dtype,
                              device=self.path_gain.device)
        return self.path_gain * p_w[:, None, None]

    @property
    def sinr(self):
        """SINR per cell with the strongest TX as the serving one"""
        rss = self.rss
        total = torch.sum(rss, dim=0, keepdim=True)
        best = torch.amax(rss, dim=0, keepdim=True)
        interference = total - best
        return (best / (interference + self._noise_power_w))[0]

    def sample_positions(self, num_pos, metric="path_gain", tx=0,
                         min_val_db=None, max_val_db=None,
                         min_dist=None, max_dist=None, seed=1):
        """Samples random positions from cells whose ``metric`` lies
        in [min_val_db, max_val_db] dB and whose distance to the
        serving TX lies in [min_dist, max_dist] m (upstream
        RadioMap.sample_positions, used to drop UEs by coverage —
        Link_Level_Simulations_with_RT.ipynb).

        Returns (positions [num_pos, 3], cell_indices [num_pos, 2])
        with positions jittered uniformly inside their cell, as host
        NumPy arrays (the map is read back to the host, and the draw is
        the JAX package's ``np.random.default_rng(seed)``)."""
        if metric == "path_gain":
            val = self.path_gain[tx]
        elif metric == "rss":
            val = self.rss[tx]
        elif metric == "sinr":
            val = self.sinr
        else:
            raise ValueError(f"Unknown metric {metric!r}")
        val = val.detach().cpu().numpy()
        db = 10. * np.log10(np.maximum(val, 1e-30))
        ok = np.isfinite(db)
        if min_val_db is not None:
            ok &= db >= min_val_db
        if max_val_db is not None:
            ok &= db <= max_val_db
        cells = np.asarray(self.cell_centers)        # [ny, nx, 3]
        if (min_dist is not None or max_dist is not None):
            if self._tx_positions is None:
                raise ValueError(
                    "Distance filters need TX positions; this "
                    "RadioMap was built without them")
            d = np.linalg.norm(
                cells - self._tx_positions[tx][None, None], axis=-1)
            if min_dist is not None:
                ok &= d >= min_dist
            if max_dist is not None:
                ok &= d <= max_dist
        iy, ix = np.nonzero(ok)
        if iy.size == 0:
            raise ValueError(
                "No radio-map cell satisfies the requested "
                "metric/distance constraints")
        rng = np.random.default_rng(seed)
        pick = rng.integers(0, iy.size, int(num_pos))
        sel = np.stack([iy[pick], ix[pick]], axis=-1)  # [num_pos, 2]
        pos = cells[sel[:, 0], sel[:, 1]].astype(np.float64)
        # jitter uniformly within the cell footprint
        if cells.shape[1] > 1:
            cx = abs(float(cells[0, 1, 0] - cells[0, 0, 0]))
        else:
            cx = 0.
        if cells.shape[0] > 1:
            cy = abs(float(cells[1, 0, 1] - cells[0, 0, 1]))
        else:
            cy = 0.
        pos[:, 0] += rng.uniform(-cx / 2, cx / 2, pos.shape[0])
        pos[:, 1] += rng.uniform(-cy / 2, cy / 2, pos.shape[0])
        return pos, sel

    def show(self, metric="path_gain", tx=0):
        """Not ported yet: plotting is ROADMAP.md queue 1, item 22."""
        raise NotImplementedError(
            "RadioMap.show is not ported yet (ROADMAP.md queue 1, item 22: "
            "plotting)")


class RadioMapSolver:
    """Computes a radio map by evaluating LoS + specular paths from
    every transmitter to a grid of measurement cells.

    ``device`` (default ``config.device``, the card) is where the map
    is computed and lives.

    Call: solver(scene, cell_size=(5., 5.), size=None, center=None,
    height=1.5, max_depth=2, ...) -> RadioMap.

    Accuracy note: the gain reduction runs fully on device and skips
    the paths-mode duplicate-path pass, so a specular point landing
    exactly on an edge shared by two coplanar triangles is counted
    once per triangle (up to +3 dB on that single path in the
    affected cell).  This measure-zero case is the only way the map
    can differ from a paths-based gain computation on the same scene.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def __call__(self, scene, cell_size=(5., 5.), size=None,
                 center=None, height=1.5, max_depth=2,
                 samples_per_src=20000, samples_per_tx=None,
                 los=True,
                 specular_reflection=True, refraction=True,
                 diffraction=False, diffuse_reflection=False,
                 diffuse_samples=1024, max_num_wedges=2000,
                 noise_power_w=1e-13):
        # upstream RadioMapSolver names the ray budget samples_per_tx
        if samples_per_tx is not None:
            samples_per_src = int(samples_per_tx)
        # Measurement grid on a horizontal plane at ``height`` (host)
        tris = scene.triangles
        if size is None:
            if tris.shape[0] > 0:
                lo = tris.reshape(-1, 3).min(axis=0)
                hi = tris.reshape(-1, 3).max(axis=0)
                size = (hi[0] - lo[0], hi[1] - lo[1])
                if center is None:
                    center = ((hi[0] + lo[0]) / 2,
                              (hi[1] + lo[1]) / 2)
            else:
                size = (100., 100.)
        if center is None:
            center = (0., 0.)
        nx = max(int(np.ceil(size[0] / cell_size[0])), 1)
        ny = max(int(np.ceil(size[1] / cell_size[1])), 1)
        xs = (np.arange(nx) - (nx - 1) / 2) * cell_size[0] + center[0]
        ys = (np.arange(ny) - (ny - 1) / 2) * cell_size[1] + center[1]
        xg, yg = np.meshgrid(xs, ys)           # [ny, nx]
        cells = np.stack(
            [xg, yg, np.full_like(xg, height)], axis=-1)

        # Evaluate with a throwaway scene configuration: isotropic
        # single-antenna receivers at every cell.  The receiver grid
        # is cached per (nx, ny, geometry) so repeated solves of the
        # same map skip ~0.5 s of per-cell object churn on the host.
        saved_rx = dict(scene.receivers)
        saved_rx_array = scene.rx_array
        saved_tx_array = scene.tx_array
        try:
            scene.receivers.clear()
            flat = cells.reshape(-1, 3)
            cache_key = (flat.shape[0],
                         float(flat[0, 0]), float(flat[0, 1]),
                         float(flat[-1, 0]), float(flat[-1, 1]),
                         float(height))
            cell_rx = getattr(self, "_cell_rx_cache", {}).get(
                cache_key)
            if cell_rx is None:
                cell_rx = {f"__cell_{i}": Receiver(f"__cell_{i}", p)
                           for i, p in enumerate(flat)}
                self._cell_rx_cache = {cache_key: cell_rx}
            scene.receivers.update(cell_rx)
            scene.rx_array = PlanarArray(1, 1, pattern="iso",
                                         polarization="V")
            if scene.tx_array is None:
                scene.tx_array = PlanarArray(1, 1, pattern="iso",
                                             polarization="V")
            solver = PathSolver(device=self.device)
            # output="gain": each solver stage reduces to the
            # incoherent per-cell gain on the device
            gain_ct = solver(scene, max_depth=max_depth,
                             samples_per_src=samples_per_src,
                             los=los,
                             specular_reflection=specular_reflection,
                             refraction=refraction,
                             diffraction=diffraction,
                             diffuse_reflection=diffuse_reflection,
                             diffuse_samples=diffuse_samples,
                             max_num_wedges=max_num_wedges,
                             output="gain")  # [cells, tx]
        finally:
            scene.receivers.clear()
            scene.receivers.update(saved_rx)
            scene.rx_array = saved_rx_array
            scene.tx_array = saved_tx_array

        gain = gain_ct.T.reshape(gain_ct.shape[1], ny, nx)  # [tx, ...]

        tx_powers = np.array(
            [t.power_dbm for t in scene.transmitters.values()])
        tx_positions = np.stack(
            [np.asarray(t.position)
             for t in scene.transmitters.values()])
        return RadioMap(gain, cells, tx_powers,
                        noise_power_w=noise_power_w,
                        tx_positions=tx_positions)
