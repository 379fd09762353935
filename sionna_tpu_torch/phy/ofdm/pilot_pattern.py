"""Pilot patterns (counterpart of ``sionna_tpu/phy/ofdm/pilot_pattern.py``).

Pure NumPy on the host, as in the JAX package: the Kronecker pilots come
from ``np.random.default_rng(seed)``, so both packages hold the same
array.
"""

import numpy as np

from ..block import Object

__all__ = ["PilotPattern", "EmptyPilotPattern", "KroneckerPilotPattern"]


class PilotPattern(Object):
    """Container for a pilot mask and pilot symbols.

    mask: [num_tx, num_streams_per_tx, num_ofdm_symbols,
    num_effective_subcarriers] bool; pilots: [num_tx,
    num_streams_per_tx, num_pilots] complex.
    """

    def __init__(self, mask, pilots, normalize=False, precision=None):
        super().__init__(precision=precision)
        self._mask = np.asarray(mask, np.int32)
        self.pilots = pilots
        self.normalize = normalize
        self._check_settings()

    @property
    def num_tx(self):
        return self._mask.shape[0]

    @property
    def num_streams_per_tx(self):
        return self._mask.shape[1]

    @property
    def num_ofdm_symbols(self):
        return self._mask.shape[2]

    @property
    def num_effective_subcarriers(self):
        return self._mask.shape[3]

    @property
    def num_pilot_symbols(self):
        return self._pilots.shape[-1]

    @property
    def num_data_symbols(self):
        return (self._mask.shape[-1] * self._mask.shape[-2]
                - self.num_pilot_symbols)

    @property
    def normalize(self):
        return self._normalize

    @normalize.setter
    def normalize(self, value):
        self._normalize = bool(value)

    @property
    def mask(self):
        return self._mask

    @property
    def pilots(self):
        """Pilots, normalized if requested."""
        p = self._pilots
        if self._normalize:
            energy = np.mean(np.abs(p) ** 2, axis=-1, keepdims=True)
            energy = np.where(energy == 0, 1.0, energy)
            p = p / np.sqrt(energy).astype(p.dtype)
        return p

    @pilots.setter
    def pilots(self, v):
        self._pilots = np.asarray(v, self.np_cdtype)

    def show(self, tx_ind=None, stream_ind=None, show_pilot_ind=False):
        """One figure of the pilot mask per (transmitter, stream)
        (matplotlib, imported here); returns the list of figures."""
        import matplotlib.pyplot as plt
        tx_ind = range(self.num_tx) if tx_ind is None else [tx_ind]
        stream_ind = range(self.num_streams_per_tx) \
            if stream_ind is None else [stream_ind]
        figs = []
        for i in tx_ind:
            for j in stream_ind:
                fig, ax = plt.subplots()
                ax.imshow(np.transpose(self._mask[i, j]),
                          origin="lower", aspect="auto")
                ax.set_title(f"TX {i} - Stream {j}")
                ax.set_xlabel("OFDM Symbol")
                ax.set_ylabel("Subcarrier")
                figs.append(fig)
        return figs

    def numpy_structure(self):
        """The pattern as NumPy arrays, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {"mask": self._mask, "pilots": self.pilots}

    def _check_settings(self):
        if self._mask.ndim != 4:
            raise ValueError("mask must have four dimensions.")
        if self._pilots.ndim != 3:
            raise ValueError("pilots must have three dimensions.")
        if self._mask.shape[:2] != tuple(self._pilots.shape[:2]):
            raise ValueError("mask and pilots must have the same first "
                             "two dimensions.")
        n_pil = int(self._mask[0, 0].sum())
        for i in range(self.num_tx):
            for j in range(self.num_streams_per_tx):
                if int(self._mask[i, j].sum()) != n_pil:
                    raise ValueError("all masks must have the same "
                                     "number of pilots.")
        if self._pilots.shape[-1] != n_pil:
            raise ValueError("the last dimension of pilots must equal "
                             "the number of masked REs.")


class EmptyPilotPattern(PilotPattern):
    """Pattern with no pilots."""

    def __init__(self, num_tx, num_streams_per_tx, num_ofdm_symbols,
                 num_effective_subcarriers, precision=None):
        mask = np.zeros([num_tx, num_streams_per_tx, num_ofdm_symbols,
                         num_effective_subcarriers], bool)
        pilots = np.zeros([num_tx, num_streams_per_tx, 0], np.complex64)
        super().__init__(mask, pilots, normalize=False,
                         precision=precision)


class KroneckerPilotPattern(PilotPattern):
    """Non-overlapping QPSK pilot sequences on selected OFDM symbols
    with frequency-time Kronecker structure."""

    def __init__(self, resource_grid, pilot_ofdm_symbol_indices,
                 normalize=True, seed=0, precision=None):
        num_tx = resource_grid.num_tx
        num_streams_per_tx = resource_grid.num_streams_per_tx
        num_ofdm_symbols = resource_grid.num_ofdm_symbols
        num_eff = resource_grid.num_effective_subcarriers
        num_pilot_symbols = len(pilot_ofdm_symbol_indices)
        num_seq = num_tx * num_streams_per_tx
        if num_eff % num_seq != 0:
            raise ValueError(
                "num_effective_subcarriers must be an integer multiple "
                "of num_tx * num_streams_per_tx.")
        num_pilots_per_symbol = num_eff // num_seq

        shape = [num_tx, num_streams_per_tx, num_ofdm_symbols, num_eff]
        mask = np.zeros(shape, bool)
        mask[..., pilot_ofdm_symbol_indices, :] = True

        shape[2] = num_pilot_symbols
        pilots = np.zeros(shape, np.complex64)
        rng = np.random.default_rng(seed)
        for i in range(num_tx):
            for j in range(num_streams_per_tx):
                b = rng.integers(
                    0, 2, (num_pilot_symbols, num_pilots_per_symbol, 2))
                p = ((1 - 2 * b[..., 0]) + 1j * (1 - 2 * b[..., 1])) \
                    / np.sqrt(2)
                pilots[i, j, :, i * num_streams_per_tx + j::num_seq] = p
        pilots = pilots.reshape([num_tx, num_streams_per_tx, -1])
        super().__init__(mask, pilots, normalize=normalize,
                         precision=precision)
