"""Viterbi and BCJR decoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/conv/decoding.py``. Both
decoders precompute the branch metrics of every time step at once, then
run their recursions over time as Python loops of [batch, states]
tensor operations (the JAX package's ``lax.scan``). A branch metric is
half the correlation of the symbol's LLRs with the branch's +-1 output
bits, summed over the code's outputs in order.

- Viterbi keeps, per step and state, the incoming branch of the best
  metric (the first on ties, as ``jnp.argmax``); the traceback then
  follows two precomputed tables (previous state, input bit) per step.
- BCJR's forward recursion gathers each state's two incoming branches
  by ``from_nodes`` and combines them with ``logaddexp`` (``map`` and
  ``log``) or ``maximum`` (``maxlog``); the JAX package reduces a masked
  one-hot instead. The backward recursion and the output LLRs are the
  JAX package's.
"""

import torch

from ...block import Block
from .utils import Trellis, polynomial_selector

__all__ = ["ViterbiDecoder", "BCJRDecoder"]

_NEG_INF = -1e9


def _resolve_trellis(encoder, gen_poly, rate, constraint_length, rsc,
                     terminate):
    if encoder is not None:
        return encoder.gen_poly, encoder.trellis, encoder.terminate
    if gen_poly is None:
        gen_poly = polynomial_selector(rate, constraint_length)
    return gen_poly, Trellis(gen_poly, rsc=rsc), terminate


def _correlate(llr, op_pm1):
    """0.5 * sum_c llr[..., c] * op_pm1[..., c], summed over c in order:
    ``llr`` [B, T, c], ``op_pm1`` [S, I, c] -> [B, T, S, I]."""
    acc = None
    for c in range(op_pm1.shape[-1]):
        term = llr[:, :, None, None, c] * op_pm1[:, :, c]
        acc = term if acc is None else acc + term
    return 0.5 * acc


class _ConvDecoderBase(Block):
    def __init__(self, *, encoder=None, gen_poly=None, rate=1 / 2,
                 constraint_length=3, rsc=False, terminate=False,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._gen_poly, self._trellis, self._terminate = _resolve_trellis(
            encoder, gen_poly, rate, constraint_length, rsc, terminate)
        tr = self._trellis
        self._mu = tr._mu
        self._conv_n = tr.conv_n
        self._ns = tr.ns
        self._ni = tr.ni
        dev = self.device
        # branch output bits in +-1 form: [ns, ni, conv_n]
        self.register_buffer("_op_pm1", torch.as_tensor(
            2 * tr.op_bits_by_fromnode - 1, device=dev), persistent=False)
        # flattened (state, input) index of each to-node's incoming
        # branches, [ns, ni]
        self.register_buffer("_from_nodes", torch.as_tensor(
            tr.from_nodes, device=dev), persistent=False)
        self.register_buffer("_to_nodes", torch.as_tensor(
            tr.to_nodes, device=dev), persistent=False)
        self.register_buffer("_in_branch", torch.as_tensor(
            tr.from_nodes * tr.ni + tr.ip_by_tonode, device=dev),
            persistent=False)
        self.register_buffer("_ip_by_tonode", torch.as_tensor(
            tr.ip_by_tonode, device=dev), persistent=False)

    @property
    def gen_poly(self):
        return self._gen_poly

    @property
    def trellis(self):
        return self._trellis

    @property
    def terminate(self):
        return self._terminate

    @property
    def coderate(self):
        return 1 / self._conv_n

    def numpy_structure(self):
        """The trellis tables, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {f"trellis.{k}": v
                for k, v in self._trellis.numpy_structure().items()}

    def _gamma(self, llr):
        """Branch metrics [B, T, ns, ni] (correlations to maximize) of
        ``llr`` [B, T, conv_n] logits."""
        return _correlate(llr, self._op_pm1.to(llr))

    def _incoming(self, x):
        """[B, ns * ni] per-branch values -> [B, ns, ni] values of each
        to-node's incoming branches."""
        idx = self._in_branch.to(x.device)
        return x[..., idx.reshape(-1)].reshape(x.shape[:-1] + idx.shape)


class ViterbiDecoder(_ConvDecoderBase):
    """Viterbi decoding.

    Input llr [..., n] as logits (or channel bits for method "hard");
    output hard info bits [..., k] (all decoded bits with
    ``return_info_bits=False``).
    """

    def __init__(self, *, encoder=None, gen_poly=None, rate=1 / 2,
                 constraint_length=3, rsc=False, terminate=False,
                 method="soft_llr", return_info_bits=True, precision=None,
                 device=None):
        super().__init__(encoder=encoder, gen_poly=gen_poly, rate=rate,
                         constraint_length=constraint_length, rsc=rsc,
                         terminate=terminate, precision=precision,
                         device=device)
        if method not in ("soft_llr", "soft", "hard"):
            raise ValueError("Unknown method")
        self._method = method
        self._return_info_bits = bool(return_info_bits)

    def forward(self, inputs, /):
        llr = torch.as_tensor(inputs).to(self.rdtype)
        in_shape = llr.shape
        num_syms = llr.shape[-1] // self._conv_n
        k = num_syms - (self._mu if self._terminate else 0)
        llr = llr.reshape(-1, num_syms, self._conv_n)
        if self._method == "hard":
            llr = 2. * llr - 1.  # bits {0, 1} -> pseudo-LLRs
        batch, dev = llr.shape[0], llr.device
        # bm[b, t, s_to, j]: metric of to-node s_to's incoming branch j
        bm = self._incoming(self._gamma(llr).reshape(batch, num_syms, -1))
        from_nodes = self._from_nodes.to(dev)
        cm = llr.new_full((batch, self._ns), _NEG_INF)
        cm[:, 0] = 0.
        best = []
        for t in range(num_syms):
            cm, j = torch.max(cm[:, from_nodes] + bm[:, t], dim=-1)
            best.append(j)
        # per step and state: the survivor's previous state and input bit
        best = torch.stack(best)  # [T, B, ns]
        states = torch.arange(self._ns, device=dev)
        prev = from_nodes[states, best]
        bit = self._ip_by_tonode.to(dev)[states, best]
        state = torch.zeros(batch, dtype=torch.int64, device=dev) \
            if self._terminate else torch.argmax(cm, dim=-1)
        bits = [None] * num_syms
        for t in range(num_syms - 1, -1, -1):
            s = state[:, None]
            bits[t] = torch.gather(bit[t], 1, s)[:, 0]
            state = torch.gather(prev[t], 1, s)[:, 0]
        bits = torch.stack(bits, dim=1)
        out_len = k if self._return_info_bits else num_syms
        out = bits[:, :out_len].to(self.rdtype)
        return out.reshape(tuple(in_shape[:-1]) + (out_len,))


class BCJRDecoder(_ConvDecoderBase):
    """BCJR (MAP) decoding.

    Input llr [..., n] as logits and an optional ``prior`` [..., k] on
    the info bits (logits); output info-bit LLRs (logits) or hard
    decisions. ``algorithm``: "map" or "log" (exact, log domain) or
    "maxlog".
    """

    def __init__(self, *, encoder=None, gen_poly=None, rate=1 / 2,
                 constraint_length=3, rsc=False, terminate=False,
                 hard_out=True, algorithm="map", precision=None,
                 device=None):
        super().__init__(encoder=encoder, gen_poly=gen_poly, rate=rate,
                         constraint_length=constraint_length, rsc=rsc,
                         terminate=terminate, precision=precision,
                         device=device)
        if algorithm not in ("map", "log", "maxlog"):
            raise ValueError("Unknown algorithm")
        self._algorithm = algorithm
        self._hard_out = bool(hard_out)

    def _pair(self, x):
        """Combines the two branches on the last axis."""
        if self._algorithm == "maxlog":
            return torch.maximum(x[..., 0], x[..., 1])
        return torch.logaddexp(x[..., 0], x[..., 1])

    def _reduce(self, x, dim):
        if self._algorithm == "maxlog":
            return torch.amax(x, dim=dim)
        return torch.logsumexp(x, dim=dim)

    def forward(self, inputs, /, prior=None):
        llr = torch.as_tensor(inputs).to(self.rdtype)
        in_shape = llr.shape
        num_syms = llr.shape[-1] // self._conv_n
        term_syms = self._mu if self._terminate else 0
        k = num_syms - term_syms
        llr = llr.reshape(-1, num_syms, self._conv_n)
        batch, dev = llr.shape[0], llr.device
        gamma = self._gamma(llr)  # [B, T, ns, ni]
        if prior is not None:
            pr = torch.as_tensor(prior).to(llr).reshape(-1, k)
            pr = torch.nn.functional.pad(pr, (0, term_syms))
            sign = torch.tensor([-1., 1.], dtype=llr.dtype, device=dev)
            gamma = gamma + 0.5 * pr[:, :, None, None] * sign
        gamma_in = self._incoming(gamma.reshape(batch, num_syms, -1))
        from_nodes = self._from_nodes.to(dev)
        to_nodes = self._to_nodes.to(dev)

        # forward recursion: alphas[t] is alpha before step t
        alpha = llr.new_full((batch, self._ns), _NEG_INF)
        alpha[:, 0] = 0.
        alphas = []
        for t in range(num_syms):
            alphas.append(alpha)
            alpha = self._pair(alpha[:, from_nodes] + gamma_in[:, t])
            alpha = alpha - torch.amax(alpha, dim=-1, keepdim=True)

        # backward recursion: betas[t] is beta after step t
        if self._terminate:
            beta = llr.new_full((batch, self._ns), _NEG_INF)
            beta[:, 0] = 0.
        else:
            beta = llr.new_zeros((batch, self._ns))
        betas = [None] * num_syms
        for t in range(num_syms - 1, -1, -1):
            betas[t] = beta
            beta = self._pair(gamma[:, t] + beta[:, to_nodes])
            beta = beta - torch.amax(beta, dim=-1, keepdim=True)

        # LLR of each input bit: log P(u=1) / P(u=0) over the branches
        alphas = torch.stack(alphas, dim=1)  # [B, T, ns]
        betas = torch.stack(betas, dim=1)
        metric = alphas[..., None] + gamma + betas[:, :, to_nodes]
        llr_out = (self._reduce(metric[..., 1], dim=-1)
                   - self._reduce(metric[..., 0], dim=-1))[:, :k]
        out = (llr_out > 0).to(self.rdtype) if self._hard_out else llr_out
        return out.reshape(tuple(in_shape[:-1]) + (k,))
