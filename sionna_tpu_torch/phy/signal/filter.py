"""Pulse-shaping filters (counterpart of ``sionna_tpu/phy/signal/filter.py``).

The taps are computed on the host by the JAX package's NumPy loops
(float32, its special points kept exactly) and kept on the block's
device as a buffer; a call windows and normalizes them there and
convolves (``signal.utils.convolve``: real ``conv1d`` calls). ``show()``
waits for the plotting slice (ROADMAP.md queue 1 item 22).
"""

import numpy as np
import torch

from ..block import Block
from .utils import convolve
from .window import Window, HannWindow, HammingWindow, BlackmanWindow

__all__ = ["Filter", "RaisedCosineFilter", "RootRaisedCosineFilter",
           "SincFilter", "CustomFilter"]


class Filter(Block):
    """Base filter of odd length K = span_in_symbols *
    samples_per_symbol (the next odd number)."""

    def __init__(self, span_in_symbols, samples_per_symbol, window=None,
                 normalize=True, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if span_in_symbols <= 0:
            raise ValueError("span_in_symbols must be positive")
        if samples_per_symbol <= 0:
            raise ValueError("samples_per_symbol must be positive")
        self._span_in_symbols = int(span_in_symbols)
        self._samples_per_symbol = int(samples_per_symbol)
        self.window = window
        if not isinstance(normalize, bool):
            raise TypeError("normalize must be bool")
        self._normalize = normalize
        self._coefficients = None
        self.register_buffer("_taps", None, persistent=False)

    @property
    def span_in_symbols(self):
        return self._span_in_symbols

    @property
    def samples_per_symbol(self):
        return self._samples_per_symbol

    @property
    def length(self):
        l = self._span_in_symbols * self._samples_per_symbol
        return 2 * (l // 2) + 1

    def __setattr__(self, name, value):
        # nn.Module would register a Window (a module) under "window"
        # itself: set it through the property, which registers it as the
        # submodule "_window"
        if name == "window":
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    @property
    def window(self):
        return self._window

    @window.setter
    def window(self, value):
        if isinstance(value, str):
            wins = {"hann": HannWindow, "hamming": HammingWindow,
                    "blackman": BlackmanWindow}
            if value not in wins:
                raise ValueError("Invalid window type")
            value = wins[value](precision=self.precision,
                                device=self.device)
        elif not (isinstance(value, Window) or value is None):
            raise TypeError("Invalid window type")
        self._window = value

    @property
    def normalize(self):
        return self._normalize

    @property
    def coefficients(self):
        """Tensor [length] of the raw taps, on the block's device"""
        return self._taps

    @coefficients.setter
    def coefficients(self, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        self._coefficients = v.astype(self.np_cdtype if np.iscomplexobj(v)
                                      else self.np_rdtype)
        self._taps = torch.as_tensor(self._coefficients, device=self.device)

    @property
    def sampling_times(self):
        """Sampling times in multiples of the symbol duration (NumPy
        float32)."""
        n_min = -(self.length // 2)
        n_max = n_min + self.length
        t = np.arange(n_min, n_max, dtype=np.float32)
        return t / self.samples_per_symbol

    def _effective_coefficients(self, conjugate=False):
        h = self._taps
        if self._window is not None:
            h = self._window(h)
        if self._normalize:
            energy = torch.sum(torch.abs(h) ** 2)
            h = h / torch.sqrt(energy).to(h.dtype)
        if conjugate and h.is_complex():
            h = torch.conj(h)
        return h

    @property
    def aclr(self):
        """ACLR of the filter (out-of-band over in-band energy, a
        rectangular in-band spectrum of one symbol bandwidth), on the
        host in NumPy."""
        h = self._effective_coefficients().cpu().numpy()
        n = max(1024, len(h))
        spec = np.abs(np.fft.fftshift(np.fft.fft(h, n))) ** 2
        f = np.fft.fftshift(np.fft.fftfreq(n)) * self.samples_per_symbol
        in_band = np.abs(f) <= 0.5
        return float(spec[~in_band].sum() / spec[in_band].sum())

    def forward(self, x, padding="full", conjugate=False):
        h = self._effective_coefficients(conjugate)
        return convolve(x, h, padding=padding, precision=self.precision)


class RaisedCosineFilter(Filter):
    """Raised-cosine filter with roll-off ``beta``."""

    def __init__(self, span_in_symbols, samples_per_symbol, beta,
                 window=None, normalize=True, precision=None, device=None):
        super().__init__(span_in_symbols, samples_per_symbol,
                         window=window, normalize=normalize,
                         precision=precision, device=device)
        if not 0 <= beta <= 1:
            raise ValueError("beta must be in [0, 1]")
        self._beta = float(beta)
        self.coefficients = self._raised_cosine(self.sampling_times, 1.0,
                                                self._beta)

    @property
    def beta(self):
        return self._beta

    @staticmethod
    def _raised_cosine(t, symbol_duration, beta):
        h = np.zeros(len(t), np.float32)
        for i, tt in enumerate(t):
            tt = abs(tt)
            if beta > 0 and abs(tt - symbol_duration / 2 / beta) < 1e-12:
                h[i] = np.pi / 4 / symbol_duration * np.sinc(1 / 2 / beta)
            else:
                h[i] = (1 / symbol_duration
                        * np.sinc(tt / symbol_duration)
                        * np.cos(np.pi * beta * tt / symbol_duration)
                        / (1 - (2 * beta * tt / symbol_duration) ** 2))
        return h


class RootRaisedCosineFilter(Filter):
    """Root-raised-cosine filter with roll-off ``beta``."""

    def __init__(self, span_in_symbols, samples_per_symbol, beta,
                 window=None, normalize=True, precision=None, device=None):
        super().__init__(span_in_symbols, samples_per_symbol,
                         window=window, normalize=normalize,
                         precision=precision, device=device)
        if not 0 <= beta <= 1:
            raise ValueError("beta must be in [0, 1]")
        self._beta = float(beta)
        self.coefficients = self._root_raised_cosine(
            self.sampling_times, 1.0, self._beta)

    @property
    def beta(self):
        return self._beta

    @staticmethod
    def _root_raised_cosine(t, symbol_duration, beta):
        h = np.zeros(len(t), np.float32)
        for i, tt in enumerate(t):
            tt = abs(tt)
            if tt < 1e-12:
                h[i] = 1 / symbol_duration * (1 + beta * (4 / np.pi - 1))
            elif beta > 0 and \
                    abs(tt - symbol_duration / 4 / beta) < 1e-12:
                h[i] = (beta / symbol_duration / np.sqrt(2)
                        * ((1 + 2 / np.pi) * np.sin(np.pi / 4 / beta)
                           + (1 - 2 / np.pi) * np.cos(np.pi / 4 / beta)))
            else:
                x = tt / symbol_duration
                h[i] = (1 / symbol_duration
                        / (np.pi * x * (1 - (4 * beta * x) ** 2))
                        * (np.sin(np.pi * x * (1 - beta))
                           + 4 * beta * x * np.cos(np.pi * x * (1 + beta))))
        return h


class SincFilter(Filter):
    """Sinc (ideal low-pass) filter."""

    def __init__(self, span_in_symbols, samples_per_symbol, window=None,
                 normalize=True, precision=None, device=None):
        super().__init__(span_in_symbols, samples_per_symbol,
                         window=window, normalize=normalize,
                         precision=precision, device=device)
        self.coefficients = self._sinc(self.sampling_times, 1.0)

    @staticmethod
    def _sinc(t, symbol_duration):
        return (1 / symbol_duration
                * np.sinc(np.asarray(t) / symbol_duration))


class CustomFilter(Filter):
    """Filter with user-provided coefficients; its length is theirs."""

    def __init__(self, samples_per_symbol, coefficients, window=None,
                 normalize=True, precision=None, device=None):
        if isinstance(coefficients, torch.Tensor):
            coefficients = coefficients.detach().cpu().numpy()
        coefficients = np.asarray(coefficients)
        span = max(1, int(np.ceil(len(coefficients) / samples_per_symbol)))
        super().__init__(span, samples_per_symbol, window=window,
                         normalize=normalize, precision=precision,
                         device=device)
        self.coefficients = coefficients

    @property
    def length(self):
        return self._coefficients.shape[0]
