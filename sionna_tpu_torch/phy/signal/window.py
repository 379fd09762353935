"""Window functions (counterpart of ``sionna_tpu/phy/signal/window.py``).

The coefficients are generated on the host in NumPy, as in the JAX
package, and kept on the block's device as a buffer, regenerated only
when a call brings a new length: a call copies nothing to the device.
``show()`` plots them with matplotlib, imported when it is called.
"""

import numpy as np
import torch

from ..block import Block

__all__ = ["Window", "CustomWindow", "HannWindow", "HammingWindow",
           "BlackmanWindow"]


class Window(Block):
    """Applies a window elementwise to an input whose last axis has the
    window's length."""

    def __init__(self, normalize=False, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(normalize, bool):
            raise TypeError("normalize must be bool")
        self._normalize = normalize
        self._coefficients = None
        self.register_buffer("_w", None, persistent=False)

    @property
    def coefficients(self):
        """Tensor [length] of the block's real dtype (None before the
        first length is known), on the block's device"""
        return self._w

    @coefficients.setter
    def coefficients(self, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        self._coefficients = np.asarray(v, self.np_rdtype)
        self._w = torch.as_tensor(self._coefficients, device=self.device)

    @property
    def length(self):
        return None if self._coefficients is None \
            else self._coefficients.shape[0]

    @property
    def normalize(self):
        return self._normalize

    def _coeffs_for(self, length):
        """The window's coefficients for ``length`` on the device;
        windows that generate their coefficients make (and keep) new
        ones when the length changes."""
        if self._coefficients is None or \
                self._coefficients.shape[0] != length:
            gen = getattr(self, "_generate", None)
            if gen is None:
                raise ValueError("Window length mismatch.")
            self.coefficients = gen(length)
        return self._w

    def show(self, samples_per_symbol, domain="time", scale="lin"):
        """Plots the window in time or its magnitude spectrum
        (matplotlib, imported here) into a new figure."""
        import matplotlib.pyplot as plt
        w = self._coefficients
        plt.figure()
        if domain == "time":
            n = len(w)
            t = (np.arange(n) - (n - 1) / 2) / samples_per_symbol
            plt.plot(t, w)
            plt.xlabel("Time (symbols)")
        else:
            spec = np.fft.fftshift(np.abs(np.fft.fft(w, 1024)))
            f = np.fft.fftshift(np.fft.fftfreq(1024)) * samples_per_symbol
            if scale == "db":
                spec = 20 * np.log10(np.maximum(spec, 1e-12))
            plt.plot(f, spec)
            plt.xlabel("Frequency (1/symbol duration)")
        plt.grid(True)

    def forward(self, x):
        w = self._coeffs_for(x.shape[-1]).to(x.device)
        if self._normalize:
            w = w / torch.sqrt(torch.mean(w ** 2))
        return x * w.to(x.dtype)


class CustomWindow(Window):
    """Window with user-provided coefficients."""

    def __init__(self, coefficients, normalize=False, precision=None,
                 device=None):
        super().__init__(normalize=normalize, precision=precision,
                         device=device)
        self.coefficients = coefficients


class HannWindow(Window):
    """Hann window."""

    def _generate(self, length):
        n = np.arange(length)
        return np.sin(np.pi * n / length) ** 2


class HammingWindow(Window):
    """Hamming window."""

    def _generate(self, length):
        n = np.arange(length)
        a0 = 25 / 46
        return a0 - (1 - a0) * np.cos(2 * np.pi * n / length)


class BlackmanWindow(Window):
    """Blackman window."""

    def _generate(self, length):
        n = np.arange(length)
        a0, a1, a2 = 7938 / 18608, 9240 / 18608, 1430 / 18608
        return (a0 - a1 * np.cos(2 * np.pi * n / length)
                + a2 * np.cos(4 * np.pi * n / length))
