"""Large-scale parameter (LSP) sampling, TR 38.901 Sec. 7.5 steps 1-4, and
the pathloss of Sec. 7.4 (counterpart of
``sionna_tpu/phy/channel/tr38901/lsp.py``).

The correlation square roots are computed on the host by NumPy's
Cholesky with the JAX package's code (the same bits) when the topology
is set, and copied to the scenario's device once. ``__call__`` and
``sample_pathloss`` draw normals from a ``torch.Generator`` and hand
them to ``lsp_from_normal`` and ``pathloss_from_normal``, which compute
deterministically (the tests feed them the JAX package's draws).
"""

import numpy as np
import torch

from ...block import Object
from ...config import config

__all__ = ["LSP", "LSPGenerator"]


class LSP(Object):
    """Container for LSP realizations; each field has shape [batch,
    num_bs, num_ut]."""

    def __init__(self, ds, asd, asa, sf, k_factor, zsa, zsd):
        super().__init__()
        self.ds = ds
        self.asd = asd
        self.asa = asa
        self.sf = sf
        self.k_factor = k_factor
        self.zsa = zsa
        self.zsd = zsd


def _cholesky_psd(mat):
    """Cholesky with a small-jitter fallback for numerically
    semi-definite matrices (e.g., co-located UTs)."""
    try:
        return np.linalg.cholesky(mat)
    except np.linalg.LinAlgError:
        eye = np.eye(mat.shape[-1], dtype=mat.dtype)
        for jitter in (1e-10, 1e-8, 1e-6, 1e-4):
            try:
                return np.linalg.cholesky(mat + jitter * eye)
            except np.linalg.LinAlgError:
                continue
        raise


class LSPGenerator(Object):
    """Samples LSPs and pathloss for a system-level scenario."""

    def __init__(self, scenario):
        super().__init__(precision=scenario.precision)
        self._scenario = scenario

    def _generator(self, generator):
        return config.generator(self._scenario.device) if generator is None \
            else generator

    def sample_pathloss(self, generator=None):
        """Total pathloss [dB] per link [batch, num_bs, num_ut]: basic
        (7.4.1) plus O2I penetration (7.4.3), in float64 as the JAX
        package's NumPy scalars promote it."""
        sc = self._scenario
        normal = torch.randn((sc.batch_size, sc.num_bs, sc.num_ut),
                             generator=self._generator(generator),
                             dtype=self.rdtype, device=sc.device)
        return self.pathloss_from_normal(normal)

    def pathloss_from_normal(self, normal):
        """The pathloss given the O2I loss's standard normal draws
        [batch, num_bs, num_ut]."""
        sc = self._scenario
        pl_b = sc.tensor("basic_pathloss").to(self.rdtype)
        if sc.o2i_model == "low":
            pl_o2i = self._o2i_loss(normal, l_glass_a=2., l_glass_b=0.2,
                                    glass_frac=0.3, std_db=4.4)
        else:
            pl_o2i = self._o2i_loss(normal, l_glass_a=23., l_glass_b=0.3,
                                    glass_frac=0.7, std_db=6.5)
        return pl_b.to(pl_o2i.dtype) + pl_o2i

    def __call__(self, generator=None):
        sc = self._scenario
        normal = torch.randn((sc.batch_size, sc.num_bs, sc.num_ut, 7),
                             generator=self._generator(generator),
                             dtype=self.rdtype, device=sc.device)
        return self.lsp_from_normal(normal)

    def lsp_from_normal(self, s):
        """The LSPs given standard normal draws [batch, num_bs, num_ut,
        7]."""
        sc = self._scenario
        s = torch.as_tensor(s).to(device=sc.device, dtype=self.rdtype)
        # cross-LSP correlation (step 4)
        s = torch.matmul(self._cross_sqrt, s[..., None])[..., 0]
        # spatial correlation across UTs, per LSP p
        s = torch.matmul(self._spatial_sqrt,
                         s.permute(0, 1, 3, 2)[..., None])[..., 0]
        s = s.permute(0, 1, 3, 2)
        lsp_log = (sc.tensor("lsp_log_std").to(self.rdtype) * s
                   + sc.tensor("lsp_log_mean").to(self.rdtype))
        lsp = torch.pow(10., lsp_log)
        # ASA/ASD limited to 104 deg, ZSA/ZSD to 52 deg
        return LSP(ds=lsp[..., 0],
                   asd=torch.clamp_max(lsp[..., 1], 104.0),
                   asa=torch.clamp_max(lsp[..., 2], 104.0),
                   sf=lsp[..., 3],
                   k_factor=lsp[..., 4],
                   zsa=torch.clamp_max(lsp[..., 5], 52.0),
                   zsd=torch.clamp_max(lsp[..., 6], 52.0))

    def topology_updated_callback(self):
        """Recomputes the correlation square roots on the host and
        copies them to the scenario's device."""
        self._compute_cross_lsp_correlation_matrix()
        self._compute_lsp_spatial_correlation_sqrt()
        dev = self._scenario.device
        self._cross_sqrt = torch.as_tensor(self._cross_lsp_corr_sqrt,
                                           device=dev).to(self.rdtype)
        self._spatial_sqrt = torch.as_tensor(self._spatial_lsp_corr_sqrt,
                                             device=dev).to(self.rdtype)

    @property
    def cross_lsp_corr_sqrt(self):
        """[batch, num_bs, num_ut, 7, 7] square roots of the cross-LSP
        correlation matrices (NumPy)"""
        return self._cross_lsp_corr_sqrt

    @property
    def spatial_lsp_corr_sqrt(self):
        """[batch, num_bs, 7, num_ut, num_ut] square roots of the LSPs'
        spatial correlation matrices (NumPy)"""
        return self._spatial_lsp_corr_sqrt

    # ------------------------------------------------------------------
    # Internal utilities
    # ------------------------------------------------------------------
    def _compute_cross_lsp_correlation_matrix(self):
        """Per-link 7x7 cross-LSP correlation matrix square root. LSP
        order: DS ASD ASA SF K ZSA ZSD."""
        sc = self._scenario
        c = np.zeros((sc.batch_size, sc.num_bs, sc.num_ut, 7, 7),
                     sc.np_rdtype)
        c[..., np.arange(7), np.arange(7)] = 1.

        pairs = [("corrASDvsDS", 0, 1), ("corrASAvsDS", 0, 2),
                 ("corrASAvsSF", 3, 2), ("corrASDvsSF", 3, 1),
                 ("corrDSvsSF", 3, 0), ("corrASDvsASA", 1, 2),
                 ("corrASDvsK", 1, 4), ("corrASAvsK", 2, 4),
                 ("corrDSvsK", 0, 4), ("corrSFvsK", 3, 4),
                 ("corrZSDvsSF", 3, 6), ("corrZSAvsSF", 3, 5),
                 ("corrZSDvsK", 6, 4), ("corrZSAvsK", 5, 4),
                 ("corrZSDvsDS", 6, 0), ("corrZSAvsDS", 5, 0),
                 ("corrZSDvsASD", 6, 1), ("corrZSAvsASD", 5, 1),
                 ("corrZSDvsASA", 6, 2), ("corrZSAvsASA", 5, 2),
                 ("corrZSDvsZSA", 5, 6)]
        for name, m, n in pairs:
            v = sc.get_param(name)
            c[..., m, n] = v
            c[..., n, m] = v
        self._cross_lsp_corr_sqrt = _cholesky_psd(c)

    def _compute_lsp_spatial_correlation_sqrt(self):
        """Spatial exp(-d/D) correlation over UT pairs sharing the same
        state, one matrix per LSP: [batch, num_bs, 7, num_ut, num_ut]."""
        sc = self._scenario
        indoor = np.broadcast_to(sc.indoor[:, None, :],
                                 (sc.batch_size, sc.num_bs, sc.num_ut))
        los_ut = sc.los
        nlos_ut = ~sc.los & ~indoor

        same_state = (
            (los_ut[..., :, None] & los_ut[..., None, :])
            | (nlos_ut[..., :, None] & nlos_ut[..., None, :])
            | (indoor[..., :, None] & indoor[..., None, :]))

        eye = np.eye(sc.num_ut, dtype=sc.np_rdtype)
        filtering = np.where(same_state, 1.0, eye)

        ut_dist_2d = sc.matrix_ut_distance_2d[:, None, :, :]  # [b,1,u,u]

        mats = []
        for name in ("corrDistDS", "corrDistASD", "corrDistASA",
                     "corrDistSF", "corrDistK", "corrDistZSA",
                     "corrDistZSD"):
            # the row UT's correlation distance; same-state pairs share
            # it, so the matrix stays symmetric
            scaling = (-1. / sc.get_param(name))[..., :, None]  # [b,s,u,1]
            mats.append(np.exp(ut_dist_2d * scaling) * filtering)
        corr = np.stack(mats, axis=2)  # [b, s, 7, u, u]
        self._spatial_lsp_corr_sqrt = _cholesky_psd(corr)

    def _o2i_loss(self, normal, l_glass_a, l_glass_b, glass_frac, std_db):
        """O2I penetration loss (7.4.3.1), low (standard glass) or high
        (IIR glass) loss model, given the normal draws. The wall loss is
        a NumPy float64 scalar in the JAX package and promotes the sum to
        float64; so here."""
        sc = self._scenario
        fc = sc.carrier_frequency / 1e9  # GHz
        l_glass = l_glass_a + l_glass_b * fc
        l_concrete = 5. + 4. * fc
        pl_tw = 5.0 - 10. * np.log10(
            glass_frac * 10 ** (-l_glass / 10.0)
            + (1. - glass_frac) * 10 ** (-l_concrete / 10.0))

        indoor_mask = sc.tensor("indoor")[:, None, :].to(self.rdtype)
        pl_in = 0.5 * sc.tensor("distance_2d_in").to(self.rdtype)
        pl_rnd = std_db * torch.as_tensor(normal).to(self.rdtype)
        f64 = torch.float64
        return (float(pl_tw) * indoor_mask.to(f64) + pl_in.to(f64)
                + (pl_rnd * indoor_mask).to(f64))
