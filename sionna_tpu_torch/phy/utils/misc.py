"""Miscellaneous utilities (counterpart of ``sionna_tpu/phy/utils/misc.py``).

The dB conversions, ``complex_normal`` and ``sample_bernoulli`` are
tensor code; a Python number or array gives a tensor on the CPU, a
tensor keeps its device. ``Interpolate`` and
``SplineGriddataInterpolation`` run on the host through SciPy, as in the
JAX package: they build the PHY abstraction's BLER tables once.
"""

from abc import ABC, abstractmethod

import numpy as np
import torch

from ..block import Block
from ..config import config, dtypes


def _rdtype(precision):
    return config.rdtype if precision is None \
        else dtypes[precision]["torch"]["rdtype"]


def _as_real(x, precision):
    return torch.as_tensor(x).to(_rdtype(precision))


def complex_normal(shape, var=1.0, precision=None, generator=None,
                   device=None):
    """Circularly-symmetric complex Gaussian samples with total variance
    ``var``, on ``device`` (default ``config.device``), drawn from
    ``generator`` (default ``config.generator`` of that device)."""
    rdtype = _rdtype(precision)
    cdtype = config.cdtype if precision is None \
        else dtypes[precision]["torch"]["cdtype"]
    device = config.device if device is None else torch.device(device)
    if generator is None:
        generator = config.generator(device)
    shape = tuple(int(s) for s in shape)
    stddev = torch.sqrt(torch.as_tensor(var, dtype=rdtype,
                                        device=device) / 2)
    xr = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    xi = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    return torch.complex(stddev * xr, stddev * xi).to(cdtype)


def lin_to_db(x, precision=None):
    """Linear scale to dB."""
    return 10 * torch.log10(_as_real(x, precision))


def db_to_lin(x, precision=None):
    """dB to linear scale."""
    return torch.pow(10.0, _as_real(x, precision) / 10)


def watt_to_dbm(x_w, precision=None):
    """Watt to dBm."""
    return 10 * torch.log10(_as_real(x_w, precision)) + 30


def dbm_to_watt(x_dbm, precision=None):
    """dBm to Watt."""
    return torch.pow(10.0, (_as_real(x_dbm, precision) - 30) / 10)


def ebnodb2no(ebno_db, num_bits_per_symbol, coderate, resource_grid=None,
              precision=None):
    """Noise variance ``No`` for a given ``Eb/No`` in dB, accounting for
    coderate, bits per symbol and, with ``resource_grid``, the OFDM
    overheads (cyclic prefix, pilots, streams). A Python number gives a
    CPU tensor; a tensor keeps its device."""
    rdtype = _rdtype(precision)
    ebno_db = torch.as_tensor(ebno_db).to(rdtype)
    dev = ebno_db.device
    ebno = torch.pow(torch.tensor(10.0, dtype=rdtype, device=dev),
                     ebno_db / 10)
    energy_per_symbol = 1.0
    if resource_grid is not None:
        energy_per_symbol /= resource_grid.num_streams_per_tx
        cp_overhead = (resource_grid.cyclic_prefix_length
                       / resource_grid.fft_size)
        num_syms = (resource_grid.num_ofdm_symbols * (1 + cp_overhead)
                    * resource_grid.num_effective_subcarriers)
        energy_per_symbol *= num_syms / resource_grid.num_data_symbols
    coderate = torch.tensor(coderate, dtype=rdtype, device=dev)
    nbps = torch.tensor(num_bits_per_symbol, dtype=rdtype, device=dev)
    energy_per_symbol = torch.tensor(energy_per_symbol, dtype=rdtype,
                                     device=dev)
    return 1 / (ebno * coderate * nbps / energy_per_symbol)


def hard_decisions(llr):
    """Elementwise hard decision: 1 if llr > 0 else 0, same dtype as
    the input."""
    llr = torch.as_tensor(llr)
    return (llr > 0).to(llr.dtype)


def log10(x):
    """Base-10 logarithm."""
    return torch.log10(torch.as_tensor(x))


def log2(x):
    """Base-2 logarithm."""
    return torch.log2(torch.as_tensor(x))


def sample_bernoulli(shape, p, precision=None, generator=None, device=None):
    """Bernoulli(p) samples of the given shape, in the real dtype, on
    ``device`` (default: ``p``'s if it is a tensor, else
    ``config.device``)."""
    rdtype = _rdtype(precision)
    if device is None:
        device = p.device if isinstance(p, torch.Tensor) else config.device
    if generator is None:
        generator = config.generator(device)
    p = torch.as_tensor(p).to(device=device, dtype=rdtype)
    u = torch.rand(tuple(int(s) for s in shape), generator=generator,
                   dtype=rdtype, device=device)
    return (u < p).to(rdtype)


def to_list(x):
    """Converts scalars/arrays to a Python list."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).tolist()
    if np.isscalar(x):
        return [x]
    return np.asarray(x).reshape(-1).tolist()


def dict_keys_to_int(x):
    """Recursively converts numeric dict keys to int."""
    if not isinstance(x, dict):
        return x
    out = {}
    for k, v in x.items():
        try:
            k = int(k)
        except (ValueError, TypeError):
            pass
        out[k] = dict_keys_to_int(v)
    return out


def scalar_to_shaped_tensor(inp, dtype, shape, device=None):
    """Broadcasts a scalar to ``shape``, or casts an existing tensor to
    ``dtype``. A scalar goes to ``device`` (default ``config.device``);
    a tensor keeps its device."""
    if isinstance(inp, torch.Tensor) and inp.dim() > 0:
        return inp.to(dtype)
    if isinstance(inp, np.ndarray) and inp.ndim > 0:
        return torch.as_tensor(inp, device=device).to(dtype)
    if isinstance(inp, torch.Tensor):
        return inp.to(dtype).expand(tuple(shape)).clone()
    if isinstance(inp, np.ndarray):
        inp = inp.item()
    return torch.full(tuple(shape), inp, dtype=dtype,
                      device=config.device if device is None else device)


class DeepUpdateDict(dict):
    """dict with recursive merge."""

    def deep_update(self, delta, stop_at_keys=()):
        for k, v in delta.items():
            if (k in self and isinstance(self[k], dict)
                    and isinstance(v, dict) and k not in stop_at_keys):
                if not isinstance(self[k], DeepUpdateDict):
                    self[k] = DeepUpdateDict(self[k])
                self[k].deep_update(v, stop_at_keys=stop_at_keys)
            else:
                self[k] = v


class Interpolate(ABC):
    """Abstract 2D interpolation onto fine grids. ``struct`` handles data
    on a rectangular (x, y) grid; ``unstruct`` scattered samples. Host
    NumPy in and out."""

    @abstractmethod
    def struct(self, z, x, y, x_interp, y_interp, **kwargs):
        """z: [N, M] on grid (x [N], y [M]) -> [L, J]"""

    @abstractmethod
    def unstruct(self, z, x, y, x_interp, y_interp, **kwargs):
        """z, x, y: [N] scattered samples -> [L, J]"""


class SplineGriddataInterpolation(Interpolate):
    """Spline (structured) and griddata (unstructured) interpolation by
    SciPy on the host, used to build the BLER tables."""

    def struct(self, z, x, y, x_interp, y_interp, spline_degree=1,
               **kwargs):
        """Spline interpolation in the log domain: zeros are replaced by
        10^(min_log - 2) before taking log10, the spline runs on
        log10(z), and interpolated values below the smallest nonzero
        sample are floored back to exactly 0 (in the linear domain the
        waterfall between CBS grid points is off by orders of
        magnitude)."""
        from scipy.interpolate import RectBivariateSpline
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        x_interp = np.asarray(x_interp, np.float64)
        y_interp = np.asarray(y_interp, np.float64)
        if len(x) <= spline_degree:
            raise ValueError("Too few points for interpolation")

        log_mat = np.zeros(z.shape)
        mat_is0 = z == 0
        if mat_is0.sum() > 0:
            log_mat_not0 = np.log10(z[~mat_is0])
            min_log_mat_not0 = min(log_mat_not0)
            log_mat[~mat_is0] = log_mat_not0
            log_mat[mat_is0] = min_log_mat_not0 - 2
        else:
            log_mat = np.log10(z)
            min_log_mat_not0 = -np.inf

        ky = min(spline_degree, len(y) - 1)
        spline = RectBivariateSpline(x, y, log_mat, kx=spline_degree,
                                     ky=ky)
        mat_interp = np.power(10, spline(x_interp, y_interp))
        mat_interp[mat_interp < 10 ** min_log_mat_not0] = 0
        return mat_interp

    def unstruct(self, z, x, y, x_interp, y_interp,
                 griddata_method="linear", **kwargs):
        from scipy.interpolate import griddata
        from scipy.spatial import QhullError
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        xg, yg = np.meshgrid(np.asarray(x_interp, np.float64),
                             np.asarray(y_interp, np.float64),
                             indexing="ij")
        pts = np.stack([x, y], axis=-1)
        if len(z) < 4:
            # too few samples to triangulate: nearest neighbour
            d2 = ((xg[..., None] - x) ** 2 + (yg[..., None] - y) ** 2)
            return z[np.argmin(d2, axis=-1)]
        try:
            return griddata(pts, z, (xg, yg), method=griddata_method)
        except (QhullError, ValueError):  # degenerate geometry
            return griddata(pts, z, (xg, yg), method="nearest")


class MCSDecoder(Block):
    """Abstract MCS-index -> (modulation order, coderate) mapping."""

    def forward(self, mcs_index, mcs_table_index, mcs_category, *,
                check_index_validity=True, **kwargs):
        raise NotImplementedError


class TransportBlock(Block):
    """Abstract (modulation order, coderate) -> (CB size, number of CBs)
    mapping."""

    def forward(self, modulation_order, target_rate, num_coded_bits,
                **kwargs):
        raise NotImplementedError


class SingleLinkChannel(Block):
    """Abstract single-link coded channel for BLER table generation."""

    def __init__(self, num_bits_per_symbol, num_info_bits, target_coderate,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.num_bits_per_symbol = num_bits_per_symbol
        self.num_info_bits = num_info_bits
        self.target_coderate = target_coderate

    @property
    def num_coded_bits(self):
        """Number of coded bits per code block: ceil(k / r) rounded up
        to a multiple of the modulation order."""
        if None in (self.num_info_bits, self.target_coderate,
                    self.num_bits_per_symbol):
            return None
        n = self.num_info_bits / self.target_coderate
        m = self.num_bits_per_symbol
        return int(np.ceil(n / m) * m)

    def forward(self, batch_size, ebno_db):
        raise NotImplementedError
