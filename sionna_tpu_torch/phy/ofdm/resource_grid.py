"""OFDM resource grid (counterpart of ``sionna_tpu/phy/ofdm/resource_grid.py``).

The mapper is one gather: for every resource element a source index
into ``cat([data, pilots, zero])`` is computed once on the host.
"""

import numpy as np
import torch

from ..block import Object, Block
from .pilot_pattern import (PilotPattern, EmptyPilotPattern,
                            KroneckerPilotPattern)

__all__ = ["ResourceGrid", "ResourceGridMapper", "ResourceGridDemapper",
           "RemoveNulledSubcarriers"]


class ResourceGrid(Object):
    """Slot geometry: OFDM symbols x subcarriers, guards, DC, pilots."""

    def __init__(self, num_ofdm_symbols, fft_size, subcarrier_spacing,
                 num_tx=1, num_streams_per_tx=1, cyclic_prefix_length=0,
                 num_guard_carriers=(0, 0), dc_null=False,
                 pilot_pattern=None, pilot_ofdm_symbol_indices=None,
                 precision=None):
        super().__init__(precision=precision)
        self._num_ofdm_symbols = int(num_ofdm_symbols)
        self._fft_size = int(fft_size)
        self._subcarrier_spacing = float(subcarrier_spacing)
        self._cyclic_prefix_length = int(cyclic_prefix_length)
        self._num_tx = int(num_tx)
        self._num_streams_per_tx = int(num_streams_per_tx)
        self._num_guard_carriers = np.array(num_guard_carriers, int)
        self._dc_null = bool(dc_null)
        self._pilot_ofdm_symbol_indices = pilot_ofdm_symbol_indices
        self.pilot_pattern = pilot_pattern
        self._check_settings()

    @property
    def cyclic_prefix_length(self):
        return self._cyclic_prefix_length

    @property
    def num_tx(self):
        return self._num_tx

    @property
    def num_streams_per_tx(self):
        return self._num_streams_per_tx

    @property
    def num_ofdm_symbols(self):
        return self._num_ofdm_symbols

    @property
    def num_resource_elements(self):
        return self._fft_size * self._num_ofdm_symbols

    @property
    def num_effective_subcarriers(self):
        return (self._fft_size - self._dc_null
                - int(np.sum(self._num_guard_carriers)))

    @property
    def effective_subcarrier_ind(self):
        """Indices of non-guard, non-DC subcarriers."""
        num_gc = self._num_guard_carriers
        sc_ind = np.arange(num_gc[0], self.fft_size - num_gc[1])
        if self.dc_null:
            sc_ind = np.delete(sc_ind, self.dc_ind - num_gc[0])
        return sc_ind

    @property
    def num_data_symbols(self):
        return (self.num_effective_subcarriers * self._num_ofdm_symbols
                - self.num_pilot_symbols)

    @property
    def num_pilot_symbols(self):
        return int(self.pilot_pattern.num_pilot_symbols)

    @property
    def num_zero_symbols(self):
        return ((self._fft_size - self.num_effective_subcarriers)
                * self._num_ofdm_symbols)

    @property
    def num_guard_carriers(self):
        return self._num_guard_carriers

    @property
    def dc_ind(self):
        return int(self._fft_size / 2 - (self._fft_size % 2 == 1) / 2)

    @property
    def fft_size(self):
        return self._fft_size

    @property
    def subcarrier_spacing(self):
        return self._subcarrier_spacing

    @property
    def ofdm_symbol_duration(self):
        return ((1. + self.cyclic_prefix_length / self.fft_size)
                / self.subcarrier_spacing)

    @property
    def bandwidth(self):
        return self.fft_size * self.subcarrier_spacing

    @property
    def num_time_samples(self):
        return ((self.fft_size + self.cyclic_prefix_length)
                * self._num_ofdm_symbols)

    @property
    def dc_null(self):
        return self._dc_null

    @property
    def pilot_pattern(self):
        return self._pilot_pattern

    @pilot_pattern.setter
    def pilot_pattern(self, value):
        if value is None or (isinstance(value, str) and value == "empty"):
            value = EmptyPilotPattern(self._num_tx,
                                      self._num_streams_per_tx,
                                      self._num_ofdm_symbols,
                                      self.num_effective_subcarriers,
                                      precision=self.precision)
        elif isinstance(value, str) and value == "kronecker":
            if self._pilot_ofdm_symbol_indices is None:
                raise ValueError(
                    "pilot_ofdm_symbol_indices must be provided for "
                    "kronecker pilot pattern.")
            value = KroneckerPilotPattern(
                self, self._pilot_ofdm_symbol_indices,
                precision=self.precision)
        elif not isinstance(value, PilotPattern):
            raise ValueError("Unsupported pilot_pattern")
        self._pilot_pattern = value

    def _check_settings(self):
        if self._num_ofdm_symbols <= 0:
            raise ValueError("num_ofdm_symbols must be positive.")
        if self.num_effective_subcarriers <= 0:
            raise ValueError("No effective subcarriers left.")
        if self.cyclic_prefix_length > self.fft_size:
            raise ValueError(
                "cyclic_prefix_length cannot be longer than fft_size.")
        pp = self._pilot_pattern
        if (pp.num_tx != self._num_tx
                or pp.num_streams_per_tx != self._num_streams_per_tx
                or pp.num_ofdm_symbols != self._num_ofdm_symbols
                or pp.num_effective_subcarriers
                != self.num_effective_subcarriers):
            raise ValueError(
                "pilot_pattern is inconsistent with the resource grid.")

    def build_type_grid(self):
        """[num_tx, num_streams_per_tx, num_ofdm_symbols, fft_size]
        int: 0=data, 1=pilot, 2=guard, 3=DC."""
        mask = self.pilot_pattern.mask  # [tx, s, sym, eff]
        shape = mask.shape[:3]
        gc_l = 2 * np.ones(shape + (self._num_guard_carriers[0],), int)
        gc_r = 2 * np.ones(shape + (self._num_guard_carriers[1],), int)
        dc = 3 * np.ones(shape + (int(self._dc_null),), int)
        split_ind = self.dc_ind - self._num_guard_carriers[0]
        return np.concatenate(
            [gc_l, mask[..., :split_ind], dc, mask[..., split_ind:],
             gc_r], -1)

    def show(self, tx_ind=0, tx_stream_ind=0):
        """The grid's resource-element types (data, pilot, guard, DC) of
        one stream (matplotlib, imported here); returns the figure."""
        import matplotlib.pyplot as plt
        grid = self.build_type_grid()[tx_ind, tx_stream_ind]
        fig, ax = plt.subplots()
        cmap = plt.cm.get_cmap("tab10", 4) if hasattr(plt.cm, "get_cmap") \
            else "tab10"
        ax.imshow(grid.T, origin="lower", aspect="auto", cmap=cmap)
        ax.set_xlabel("OFDM Symbol")
        ax.set_ylabel("Subcarrier")
        return fig


class ResourceGridMapper(Block):
    """Maps data symbols (+ pilots) onto the resource grid.

    Input [batch, num_tx, num_streams_per_tx, num_data_symbols] ->
    [batch, num_tx, num_streams_per_tx, num_ofdm_symbols, fft_size].
    """

    def __init__(self, resource_grid, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._resource_grid = rg = resource_grid
        rg_type = rg.build_type_grid()  # [tx, s, sym, fft]
        n_data = rg.num_data_symbols
        n_pil = rg.num_pilot_symbols
        # per (tx, stream): source index into cat([data, pilots, zero])
        # for each (sym, subcarrier)
        src = np.full(rg_type.shape, n_data + n_pil, np.int64)
        for i in range(rg.num_tx):
            for j in range(rg.num_streams_per_tx):
                flat = rg_type[i, j].reshape(-1)
                d_pos = np.where(flat == 0)[0]
                p_pos = np.where(flat == 1)[0]
                s = src[i, j].reshape(-1)
                s[d_pos] = np.arange(len(d_pos))
                s[p_pos] = n_data + np.arange(len(p_pos))
                src[i, j] = s.reshape(rg_type.shape[2:])
        self.register_buffer(
            "_src_idx", torch.as_tensor(
                src.reshape(rg.num_tx, rg.num_streams_per_tx, -1),
                device=self.device), persistent=False)
        self.register_buffer(
            "_pilots", torch.as_tensor(rg.pilot_pattern.pilots,
                                       device=self.device).to(self.cdtype),
            persistent=False)

    def numpy_structure(self):
        """The grid's pilots and pilot mask, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {f"pilot_pattern.{k}": v for k, v in
                self._resource_grid.pilot_pattern.numpy_structure().items()}

    def forward(self, inputs):
        rg = self._resource_grid
        x = torch.as_tensor(inputs).to(self.cdtype)
        batch = x.shape[0]
        pilots = self._pilots.expand((batch,) + tuple(self._pilots.shape))
        zero = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype,
                           device=x.device)
        src_vals = torch.cat([x, pilots, zero], dim=-1)
        idx = self._src_idx.expand((batch,) + tuple(self._src_idx.shape))
        grid = torch.gather(src_vals, -1, idx)
        return grid.reshape(batch, rg.num_tx, rg.num_streams_per_tx,
                            rg.num_ofdm_symbols, rg.fft_size)


class ResourceGridDemapper(Block):
    """Extracts the data-carrying resource elements from a resource grid.

    Input [batch, num_rx, num_streams_per_rx, num_ofdm_symbols,
    fft_size(, data_dim)] -> [batch, num_tx, num_streams_per_tx,
    num_data_symbols(, data_dim)]: the streams are put in transmitter
    order, then each one's data positions are gathered.
    """

    def __init__(self, resource_grid, stream_management, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._resource_grid = rg = resource_grid
        self._stream_management = stream_management
        rg_type = rg.build_type_grid()
        # per (tx, stream) flat positions of the data REs
        data_pos = np.stack(
            [[np.where(rg_type[i, j].reshape(-1) == 0)[0]
              for j in range(rg.num_streams_per_tx)]
             for i in range(rg.num_tx)])
        self.register_buffer(
            "_data_pos", torch.as_tensor(data_pos, device=self.device),
            persistent=False)
        self.register_buffer(
            "_stream_ind", torch.as_tensor(
                np.asarray(stream_management.stream_ind, np.int64),
                device=self.device), persistent=False)

    def forward(self, y):
        rg = self._resource_grid
        y = torch.as_tensor(y)
        has_data_dim = y.dim() == 6
        if not has_data_dim:
            y = y[..., None]
        batch, data_dim = y.shape[0], y.shape[-1]
        y = y.reshape(batch, -1, rg.num_ofdm_symbols * rg.fft_size, data_dim)
        y = torch.index_select(y, 1, self._stream_ind.to(y.device))
        y = y.reshape(batch, rg.num_tx, rg.num_streams_per_tx,
                      rg.num_ofdm_symbols * rg.fft_size, data_dim)
        idx = self._data_pos.to(y.device)[None, ..., None].expand(
            (batch,) + tuple(self._data_pos.shape) + (data_dim,))
        out = torch.gather(y, 3, idx)
        return out if has_data_dim else out[..., 0]


class RemoveNulledSubcarriers(Block):
    """Removes guard and DC subcarriers from a full resource grid.

    Input [..., fft_size] -> [..., num_effective_subcarriers].
    """

    def __init__(self, resource_grid, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.register_buffer(
            "_sc_ind", torch.as_tensor(resource_grid.effective_subcarrier_ind,
                                       dtype=torch.int64, device=self.device),
            persistent=False)

    def forward(self, inputs):
        x = torch.as_tensor(inputs)
        return torch.index_select(x, -1, self._sc_ind.to(x.device))
