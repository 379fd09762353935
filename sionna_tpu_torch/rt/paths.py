"""Propagation-path container (API parity with sionna.rt.Paths).

PyTorch counterpart of ``sionna_tpu/rt/paths.py``: the fields are
tensors on the solver's device, and the CIR, CFR and taps are computed
there."""

import torch

from ..phy.constants import PI

__all__ = ["Paths"]


class Paths:
    """Propagation paths (API parity with sionna.rt.Paths).

    a : [num_rx, num_rx_ant, num_tx, num_tx_ant, num_paths] complex64
        path coefficients (without Doppler)
    tau : [num_rx, num_tx, num_paths] delays [s] (-1 where invalid)
    valid, theta_t, phi_t, theta_r, phi_r, doppler : [num_rx, num_tx,
        num_paths]
    interactions : [num_paths, max_depth] triangle ids (-1 padded)
    types : [num_paths] 0 LoS, 1 specular, 2 diffracted, 3 scattered
        (upstream InteractionType codes)

    Every field is a tensor on the solver's device."""

    def __init__(self, a, tau, valid, theta_t, phi_t, theta_r, phi_r,
                 doppler, interactions, types=None):
        self.a = a
        self.tau = tau
        self.valid = valid
        self.theta_t = theta_t
        self.phi_t = phi_t
        self.theta_r = theta_r
        self.phi_r = phi_r
        self.doppler = doppler
        self.interactions = interactions
        self.types = (types if types is not None
                      else torch.zeros(self.a.shape[-1], dtype=torch.int32,
                                       device=self.a.device))

    @property
    def num_paths(self):
        return self.a.shape[-1]

    def cir(self, sampling_frequency=None, num_time_steps=1,
            normalize_delays=False, out_type="torch"):
        """Channel impulse response with Doppler evolution.

        Returns (a [num_rx, num_rx_ant, num_tx, num_tx_ant,
        num_paths, num_time_steps] complex64, tau [num_rx, num_tx,
        num_paths]): tensors on the paths' device for
        ``out_type="torch"``, NumPy arrays for ``"numpy"``."""
        if out_type not in ("torch", "numpy"):
            raise ValueError("out_type must be 'torch' or 'numpy'")
        if sampling_frequency is None:
            sampling_frequency = 1.
        dev = self.a.device
        doppler = self.doppler
        t = torch.arange(num_time_steps, dtype=doppler.dtype,
                         device=dev) / sampling_frequency
        phase = torch.exp(2j * PI * doppler[..., None] * t)  # [rx,tx,P,T]
        a = (self.a[..., None]
             * phase[:, None, :, None, :, :]).to(torch.complex64)
        tau = self.tau
        if normalize_delays:
            tau_min = torch.amin(torch.where(self.valid, tau, torch.inf),
                                 dim=-1, keepdim=True)
            tau_min = torch.where(torch.isfinite(tau_min), tau_min, 0.)
            tau = torch.where(self.valid, tau - tau_min, tau)
        if out_type == "numpy":
            return a.detach().cpu().numpy(), tau.detach().cpu().numpy()
        return a, tau

    def cfr(self, frequencies, sampling_frequency=None,
            num_time_steps=1, normalize_delays=False,
            normalize=False, out_type="torch"):
        """Channel frequency response at baseband ``frequencies``
        (upstream Paths.cfr):

        h[..., t, f] = sum_p a_p(t) exp(-2j pi f tau_p)

        Returns [num_rx, num_rx_ant, num_tx, num_tx_ant,
        num_time_steps, num_freqs]."""
        from ..phy.channel.utils import cir_to_ofdm_channel
        a, tau = self.cir(sampling_frequency=sampling_frequency,
                          num_time_steps=num_time_steps,
                          normalize_delays=normalize_delays)
        frequencies = torch.as_tensor(frequencies, device=a.device)
        # cir_to_ofdm_channel takes [b, rx, rxa, tx, txa, P, T] with tau
        # [b, rx, tx, P]
        h = cir_to_ofdm_channel(frequencies, a[None], tau[None],
                                normalize=normalize)[0]
        if out_type == "numpy":
            return h.detach().cpu().numpy()
        return h

    def taps(self, bandwidth, l_min, l_max, sampling_frequency=None,
             num_time_steps=1, normalize=False,
             normalize_delays=True, out_type="torch"):
        """Bandlimited discrete-time channel taps (upstream
        Paths.taps): sinc-reconstructed taps at lags l_min..l_max for
        a system of ``bandwidth`` Hz.

        Returns [num_rx, num_rx_ant, num_tx, num_tx_ant,
        num_time_steps, l_max - l_min + 1]."""
        from ..phy.channel.utils import cir_to_time_channel
        a, tau = self.cir(sampling_frequency=sampling_frequency,
                          num_time_steps=num_time_steps,
                          normalize_delays=normalize_delays)
        hm = cir_to_time_channel(bandwidth, a[None], tau[None],
                                 l_min, l_max, normalize=normalize)[0]
        if out_type == "numpy":
            return hm.detach().cpu().numpy()
        return hm
