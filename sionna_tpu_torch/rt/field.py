"""Field combination stage shared by all RT interaction evaluators:
applies antenna patterns in device-local frames, synthetic-array
phase offsets, and per-path Doppler to Jones matrices, producing the
Paths-layout output dict.

PyTorch counterpart of ``sionna_tpu/rt/field.py``."""

import numpy as np
import torch

from ..phy.constants import PI, SPEED_OF_LIGHT
from .geometry import rot_matrix, sph_basis, unit_to_angles

__all__ = ["combine_paths"]


def _device_array(array, like):
    """A host array as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(array, dtype=like.dtype, device=like.device)


def combine_paths(scene, txs, rxs, d0_hat, u_r, jones, amp, valid,
                  tau):
    """Applies antenna patterns, synthetic-array phase offsets and
    Doppler to per-path Jones matrices, producing the Paths-layout
    output dict.

    d0_hat/u_r: [P,tx,rx,3] departure direction / arrival
    direction (pointing from the RX back along the last segment);
    jones [P,tx,rx,2,2] maps the TX spherical basis of ``d0_hat``
    to the RX spherical basis of ``u_r``; amp [P,tx,rx] carries
    spreading + propagation phase; tau in seconds."""
    lam = scene.wavelength

    # --- Antenna patterns in device-local frames
    theta_t_g, phi_t_g = unit_to_angles(d0_hat)
    theta_r_g, phi_r_g = unit_to_angles(u_r)

    rot_tx = _device_array(
        rot_matrix(np.stack([t.orientation for t in txs])), d0_hat)
    rot_rx = _device_array(
        rot_matrix(np.stack([r.orientation for r in rxs])), d0_hat)
    d0_loc = torch.einsum("tij,stri->strj", rot_tx, d0_hat)
    ur_loc = torch.einsum("rij,stri->strj", rot_rx, u_r)
    th_t_l, ph_t_l = unit_to_angles(d0_loc)
    th_r_l, ph_r_l = unit_to_angles(ur_loc)

    # F: ([S,tx,rx,ant] theta-comp, phi-comp)
    f_t_th, f_t_ph = scene.tx_array.field(th_t_l, ph_t_l)
    f_r_th, f_r_ph = scene.rx_array.field(th_r_l, ph_r_l)
    # Rotate local pattern components to the global basis via the
    # projections of the rotated local basis vectors
    e_th_t_l, e_ph_t_l = sph_basis(d0_loc)
    e_th_t_g, e_ph_t_g = sph_basis(d0_hat)
    # global field = R^T (local basis vectors) . components
    rt_t = torch.swapaxes(rot_tx, -2, -1)
    e_th_t_gl = torch.einsum("tij,strj->stri", rt_t, e_th_t_l)
    e_ph_t_gl = torch.einsum("tij,strj->stri", rt_t, e_ph_t_l)
    # projections onto the global (theta, phi) basis
    m_tt = torch.sum(e_th_t_g * e_th_t_gl, -1)
    m_tp = torch.sum(e_th_t_g * e_ph_t_gl, -1)
    m_pt = torch.sum(e_ph_t_g * e_th_t_gl, -1)
    m_pp = torch.sum(e_ph_t_g * e_ph_t_gl, -1)
    f_t_th_g = (m_tt[..., None] * f_t_th
                + m_tp[..., None] * f_t_ph)
    f_t_ph_g = (m_pt[..., None] * f_t_th
                + m_pp[..., None] * f_t_ph)

    e_th_r_l, e_ph_r_l = sph_basis(ur_loc)
    e_th_r_g, e_ph_r_g = sph_basis(u_r)
    rt_r = torch.swapaxes(rot_rx, -2, -1)
    e_th_r_gl = torch.einsum("rij,strj->stri", rt_r, e_th_r_l)
    e_ph_r_gl = torch.einsum("rij,strj->stri", rt_r, e_ph_r_l)
    w_tt = torch.sum(e_th_r_g * e_th_r_gl, -1)
    w_tp = torch.sum(e_th_r_g * e_ph_r_gl, -1)
    w_pt = torch.sum(e_ph_r_g * e_th_r_gl, -1)
    w_pp = torch.sum(e_ph_r_g * e_ph_r_gl, -1)
    f_r_th_g = (w_tt[..., None] * f_r_th
                + w_tp[..., None] * f_r_ph)
    f_r_ph_g = (w_pt[..., None] * f_r_th
                + w_pp[..., None] * f_r_ph)

    # --- Combine: a[s,tx,rx,ra,ta] =
    #   F_r^T . J . F_t * lam/(4 pi d) * exp(-j2 pi d/lam)
    f_t = torch.stack([f_t_th_g, f_t_ph_g],
                      dim=-2).to(torch.complex64)  # [S,t,r,2,ta]
    f_r = torch.stack([f_r_th_g, f_r_ph_g],
                      dim=-2).to(torch.complex64)  # [S,t,r,2,ra]
    field = torch.einsum("stria,strij,strjb->strab",
                         f_r, jones, f_t)  # [S,t,r,ra,ta]

    # --- Array phase offsets (plane-wave / synthetic array)
    pos_t = torch.as_tensor(scene.tx_array.positions(lam),
                            dtype=d0_hat.dtype, device=d0_hat.device)
    pos_r = torch.as_tensor(scene.rx_array.positions(lam),
                            dtype=d0_hat.dtype, device=d0_hat.device)
    rot_pt = torch.einsum("tij,aj->tai", rt_t, pos_t)
    rot_pr = torch.einsum("rij,aj->rai", rt_r, pos_r)
    ph_t = torch.exp(1j * (2. * PI / lam * torch.einsum(
        "tai,stri->stra", rot_pt, d0_hat)).to(torch.float32))
    ph_r = torch.exp(1j * (-2. * PI / lam * torch.einsum(
        "rai,stri->stra", rot_pr, u_r)).to(torch.float32))
    a = (field * amp[..., None, None]
         * ph_r[..., :, None] * ph_t[..., None, :])

    # --- Doppler per path
    v_tx = _device_array(np.stack([t.velocity for t in txs]), d0_hat)
    v_rx = _device_array(np.stack([r.velocity for r in rxs]), d0_hat)
    fd = (scene.frequency / SPEED_OF_LIGHT) * (
        torch.einsum("ti,stri->str", v_tx, d0_hat)
        + torch.einsum("ri,stri->str", v_rx, u_r))

    # --- Mask invalid paths and reorder to Paths layout
    a = a * valid.to(torch.complex64)[..., None, None]
    # [S,tx,rx,...] -> [rx, ra, tx, ta, S] etc.
    a = torch.permute(a, (2, 3, 1, 4, 0))
    out = {
        "a": a,
        "tau": torch.permute(torch.where(valid, tau, -1.), (2, 1, 0)),
        "valid": torch.permute(valid, (2, 1, 0)),
        "theta_t": torch.permute(theta_t_g, (2, 1, 0)),
        "phi_t": torch.permute(phi_t_g, (2, 1, 0)),
        "theta_r": torch.permute(theta_r_g, (2, 1, 0)),
        "phi_r": torch.permute(phi_r_g, (2, 1, 0)),
        "doppler": torch.permute(torch.where(valid, fd, 0.), (2, 1, 0)),
    }
    return out
