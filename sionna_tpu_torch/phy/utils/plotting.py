"""BER/BLER plotting (PyTorch-port counterpart of
``sionna_tpu/phy/utils/plotting.py``).

Matplotlib is imported inside each function, so that simulation jobs
(and hosts without matplotlib) never import it. Curves are kept on the
host as float64 NumPy arrays; tensors are moved there first.
"""

import numpy as np
import torch

from .sim import sim_ber

__all__ = ["plot_ber", "PlotBER"]


def _host(x):
    """A tensor (on any device) or array-like as a float64 NumPy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def plot_ber(snr_db, ber, legend="", ylabel="BER", title="Bit Error Rate",
             ebno=True, is_bler=None, xlim=None, ylim=None, save_fig=False,
             path=""):
    """Plots BER/BLER curves on a log scale; returns ``(fig, ax)``.

    ``snr_db`` [num_points] or [num_curves, num_points] and ``ber``
    [num_curves, num_points]; ``is_bler`` draws the marked curves
    dashed; ``save_fig`` writes the figure to ``path`` and closes it."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(16, 10))
    plt.xticks(fontsize=18)
    plt.yticks(fontsize=18)
    plt.title(title, fontsize=25)

    snr_db = np.atleast_2d(_host(snr_db))
    ber = np.atleast_2d(_host(ber))
    if snr_db.shape[0] == 1 and ber.shape[0] > 1:
        snr_db = np.tile(snr_db, (ber.shape[0], 1))
    if isinstance(legend, str):
        legend = [legend] * ber.shape[0]
    if is_bler is None:
        is_bler = [False] * ber.shape[0]
    elif isinstance(is_bler, bool):
        is_bler = [is_bler] * ber.shape[0]

    for idx in range(ber.shape[0]):
        style = "--" if is_bler[idx] else ""
        plt.semilogy(snr_db[idx], ber[idx], style, linewidth=2)

    plt.grid(which="both")
    xlabel = r"$E_b/N_0$ (dB)" if ebno else r"$E_s/N_0$ (dB)"
    plt.xlabel(xlabel, fontsize=25)
    plt.ylabel(ylabel, fontsize=25)
    plt.legend(legend, fontsize=20)
    if xlim is not None:
        plt.xlim(xlim)
    if ylim is not None:
        plt.ylim(ylim)
    if save_fig:
        plt.savefig(path)
        plt.close(fig)
    return fig, ax


class PlotBER:
    """Stateful BER/BLER plotting: stores curves (``add``, ``simulate``
    through :func:`sim_ber`) and draws them together (``__call__``)."""

    def __init__(self, title="Bit/Block Error Rate"):
        self._title = title
        self._bers = []
        self._snrs = []
        self._legends = []
        self._is_bler = []

    @property
    def ber(self):
        return self._bers

    @property
    def snr(self):
        return self._snrs

    @property
    def legend(self):
        return self._legends

    @property
    def is_bler(self):
        return self._is_bler

    def add(self, ebno_db, ber, is_bler=False, legend=""):
        """Adds a stored curve."""
        self._snrs.append(_host(ebno_db))
        self._bers.append(_host(ber))
        self._legends.append(legend)
        self._is_bler.append(bool(is_bler))

    def remove(self, idx=-1):
        """Removes curve at index ``idx``."""
        for lst in (self._snrs, self._bers, self._legends, self._is_bler):
            lst.pop(idx)

    def reset(self):
        """Removes all stored curves."""
        self._snrs, self._bers = [], []
        self._legends, self._is_bler = [], []

    def __call__(self, xlim=None, ylim=None, save_fig=False, path="",
                 show_ber=True, show_bler=True):
        """Plots the stored curves (BER, BLER or both); returns
        ``(fig, ax)``, or None when no curve is selected."""
        snrs, bers, legends, is_bler = [], [], [], []
        for s, b, l, ib in zip(self._snrs, self._bers, self._legends,
                               self._is_bler):
            if ib and not show_bler:
                continue
            if not ib and not show_ber:
                continue
            snrs.append(s)
            bers.append(b)
            legends.append(l)
            is_bler.append(ib)
        if not bers:
            return None
        max_len = max(len(b) for b in bers)
        snr_mat = np.full((len(bers), max_len), np.nan)
        ber_mat = np.full((len(bers), max_len), np.nan)
        for i, (s, b) in enumerate(zip(snrs, bers)):
            snr_mat[i, :len(s)] = s
            ber_mat[i, :len(b)] = b
        ylabel = "BER / BLER" if (show_ber and show_bler) else (
            "BER" if show_ber else "BLER")
        return plot_ber(snr_mat, ber_mat, legend=legends, ylabel=ylabel,
                        title=self._title, is_bler=is_bler, xlim=xlim,
                        ylim=ylim, save_fig=save_fig, path=path)

    def simulate(self, mc_fun, ebno_dbs, batch_size, max_mc_iter,
                 legend="", add_ber=True, add_bler=False, show_fig=True,
                 **kwargs):
        """Runs :func:`sim_ber` and stores/plots the results."""
        ber, bler = sim_ber(mc_fun, ebno_dbs, batch_size,
                            max_mc_iter=max_mc_iter, **kwargs)
        if add_ber:
            self.add(ebno_dbs, ber, is_bler=False, legend=legend)
        if add_bler:
            self.add(ebno_dbs, bler, is_bler=True,
                     legend=legend + " (BLER)" if legend else "BLER")
        if show_fig:
            self()
        return ber, bler
