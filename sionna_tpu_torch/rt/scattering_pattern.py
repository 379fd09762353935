"""Diffuse scattering re-radiation patterns.

PyTorch counterpart of ``sionna_tpu/rt/scattering_pattern.py``.

Implements the effective-roughness scattering lobes of
V. Degli-Esposti et al., "Measurement and modelling of scattering
from buildings" (IEEE TAP 2007), matching the upstream Sionna RT API
surface (``LambertianPattern`` / ``DirectivePattern`` /
``BackscatteringPattern``; the upstream RT package is out-of-tree,
see SURVEY.md section 2.12).

Each pattern is a probability density over the hemisphere above the
surface: integral of f(k_i, k_s) over outgoing solid angle equals 1
for any incidence direction, so the scattered power calibration in
``solver._eval_scattering`` is pattern-independent.

The directive lobes need the closed-form normalization

    F_alpha(theta_i) = 2^-alpha * sum_k C(alpha, k) I_k
    I_k = 2 pi / (k + 1)                              (k even)
    I_k = (2 pi / (k + 1)) cos(theta_i)
          * sum_{w=0}^{(k-1)/2} C(2w, w) sin(theta_i)^(2w) / 4^w
                                                      (k odd)

which this module rearranges into ``F = A + cos(theta_i) *
polynomial(sin(theta_i)^2)`` with per-alpha constant coefficients so
the solver can evaluate mixed-material batches with one gather
(validated against Monte-Carlo hemisphere integration in
``tests/test_rt_scattering.py``, for the JAX package).
"""

from math import comb

import numpy as np
import torch

PI = float(np.pi)

__all__ = ["ScatteringPattern", "LambertianPattern",
           "DirectivePattern", "BackscatteringPattern"]


def lobe_norm_coeffs(alpha):
    """Coefficients (A, B[w]) of the hemisphere integral of the
    directive lobe ((1 + cos psi)/2)^alpha around a direction at
    angle theta_i from the surface normal:

        F_alpha(theta_i) = A + cos(theta_i) * sum_w B[w] * s^w,
        s = sin(theta_i)^2.
    """
    alpha = int(alpha)
    if alpha < 1:
        raise ValueError("alpha must be a positive integer")
    a_const = 0.0
    n_w = (alpha - 1) // 2 + 1 if alpha >= 1 else 0
    b = np.zeros(max(n_w, 1), np.float64)
    for k in range(alpha + 1):
        c = comb(alpha, k) * 2. * PI / (k + 1) / 2. ** alpha
        if k % 2 == 0:
            a_const += c
        else:
            for w in range((k - 1) // 2 + 1):
                b[w] += c * comb(2 * w, w) / 4. ** w
    return float(a_const), b


def eval_lobe_norm(a_const, b, cos_theta_i):
    """F_alpha(theta_i) from `lobe_norm_coeffs` output. Broadcasts
    over cos_theta_i; b may carry a leading batch dim matching it."""
    cos_t = torch.clamp(cos_theta_i, 0., 1.)
    s = 1. - cos_t ** 2
    b = torch.as_tensor(b, dtype=cos_t.dtype, device=cos_t.device)
    powers = torch.stack(
        [s ** w for w in range(b.shape[-1])], dim=-1)
    poly = torch.sum(b * powers, dim=-1)
    return a_const + cos_t * poly


class ScatteringPattern:
    """Base class; subclasses define the density f(k_i, k_s, n).

    ``k_i`` points from the transmitter TOWARDS the surface, ``k_s``
    away from the surface towards the receiver, ``n`` is the outward
    unit normal (oriented into the incident halfspace). All inputs
    broadcast; the trailing axis is xyz.
    """

    def __call__(self, k_i, k_s, n):
        raise NotImplementedError

    # canonical (is_lambertian, lambda_, alpha_r, alpha_i) encoding
    # used by the solver to batch mixed-material scenes
    def canonical(self):
        raise NotImplementedError


class LambertianPattern(ScatteringPattern):
    """f = cos(theta_s) / pi (pattern of an ideal rough surface)."""

    def __call__(self, k_i, k_s, n):
        cos_s = torch.clamp(torch.sum(k_s * n, -1), 0., 1.)
        return cos_s / PI

    def canonical(self):
        return (True, 1.0, 1, 1)

    def __repr__(self):
        return "LambertianPattern()"


class BackscatteringPattern(ScatteringPattern):
    """Weighted sum of a lobe around the specular direction and a
    lobe back towards the transmitter:

        f = lambda_ * ((1+cos psi_r)/2)^alpha_r / F_{alpha_r}
          + (1-lambda_) * ((1+cos psi_i)/2)^alpha_i / F_{alpha_i}

    with psi_r the angle of k_s from the specular reflection of k_i
    and psi_i its angle from -k_i. Integer ``alpha_r``/``alpha_i``
    control lobe width; ``lambda_`` in [0, 1] splits the energy.
    """

    def __init__(self, alpha_r, alpha_i, lambda_=0.5):
        self.alpha_r = int(alpha_r)
        self.alpha_i = int(alpha_i)
        self.lambda_ = float(lambda_)
        if not 0. <= self.lambda_ <= 1.:
            raise ValueError("lambda_ must be in [0, 1]")
        self._cr = lobe_norm_coeffs(self.alpha_r)
        self._ci = lobe_norm_coeffs(self.alpha_i)

    def __call__(self, k_i, k_s, n):
        cos_i = torch.clamp(-torch.sum(k_i * n, -1), 0., 1.)
        k_r = k_i - 2. * torch.sum(k_i * n, -1, keepdim=True) * n
        cos_pr = torch.clamp(torch.sum(k_r * k_s, -1), -1., 1.)
        cos_pi = torch.clamp(-torch.sum(k_i * k_s, -1), -1., 1.)
        f_r = ((1. + cos_pr) / 2.) ** self.alpha_r \
            / eval_lobe_norm(*self._cr, cos_i)
        f_i = ((1. + cos_pi) / 2.) ** self.alpha_i \
            / eval_lobe_norm(*self._ci, cos_i)
        return self.lambda_ * f_r + (1. - self.lambda_) * f_i

    def canonical(self):
        return (False, self.lambda_, self.alpha_r, self.alpha_i)

    def __repr__(self):
        return (f"BackscatteringPattern(alpha_r={self.alpha_r}, "
                f"alpha_i={self.alpha_i}, lambda_={self.lambda_})")


class DirectivePattern(BackscatteringPattern):
    """Single lobe around the specular direction
    (``BackscatteringPattern`` with lambda_=1)."""

    def __init__(self, alpha_r):
        super().__init__(alpha_r, alpha_r, lambda_=1.0)

    def __repr__(self):
        return f"DirectivePattern(alpha_r={self.alpha_r})"


def pack_patterns(patterns, max_alpha=None):
    """Packs a list of patterns (one per material) into dense arrays
    for batched on-device evaluation:

    returns dict with float32/int arrays over materials:
      is_lamb [M], lambda_ [M], a_r/a_i [M] (float exponents),
      Ar/Ai [M] + Br/Bi [M, W] (normalization coefficients, padded).
    """
    cans = [p.canonical() for p in patterns]
    alphas = [a for _, _, ar, ai in cans for a in (ar, ai)]
    w_max = max((int(a) - 1) // 2 + 1 for a in alphas)
    if max_alpha is not None:
        w_max = max(w_max, (int(max_alpha) - 1) // 2 + 1)
    m = len(patterns)
    out = {"is_lamb": np.zeros(m, np.bool_),
           "lambda_": np.zeros(m, np.float32),
           "a_r": np.zeros(m, np.float32),
           "a_i": np.zeros(m, np.float32),
           "Ar": np.zeros(m, np.float32),
           "Ai": np.zeros(m, np.float32),
           "Br": np.zeros((m, w_max), np.float32),
           "Bi": np.zeros((m, w_max), np.float32)}
    for j, (is_lamb, lam, ar, ai) in enumerate(cans):
        out["is_lamb"][j] = is_lamb
        out["lambda_"][j] = lam
        out["a_r"][j], out["a_i"][j] = ar, ai
        cr_a, cr_b = lobe_norm_coeffs(ar)
        ci_a, ci_b = lobe_norm_coeffs(ai)
        out["Ar"][j], out["Ai"][j] = cr_a, ci_a
        out["Br"][j, :len(cr_b)] = cr_b
        out["Bi"][j, :len(ci_b)] = ci_b
    return out
