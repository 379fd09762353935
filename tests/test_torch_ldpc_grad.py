"""Gradients through the port's lifted 5G LDPC decoder
(``sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py``) against ``jax.grad``
through the JAX package's lifted engine (``engine="lifted"``: XLA's
autodiff of ``LDPC5GLiftedBP.decode`` and ``decode_layered``).

On the CPU the decoder's LLRs that require grad go through
``LiftedBPFunction`` with the plain tape forward and reverse, which are
the CUDA kernels K5f/K5b and K5Lf/K5Lb's oracles, so these tests hold the
kernels' reverse schedule to JAX. Same inputs (numpy, seeded; the link's
bits and noise drawn by JAX) through both packages.

Tolerance: 1e-4 of the largest |gradient|, as the segment engine's
gradient test. Measured (CPU): up to 1.1e-6 for the tanh rule (XLA:CPU's
f32 tanh/log1p differ from torch's by a few ULP), 1.7e-7 for min-sum
(summation order), 6.3e-7 for the link.

The JAX references run op by op (``jax.grad`` under ``jax.disable_jit``):
jitted, each (check node, schedule, iterations, code) is a program of
its own that XLA:CPU takes 20-40 s to compile on one core, where op by
op the first call on a code's shapes takes about 15 s (each operation
compiled once) and later ones about 3 s per iteration. So every code is
lifted by Z=18 and decoded in batches of 3, the cases cover each rule
and schedule once, and BP-5 runs only for layered min-sum and for the
link (flooding boxplus): about 130 s for the file on one core.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import sionna_tpu.phy as jphy
import sionna_tpu.phy.fec.ldpc as jldpc
from sionna_tpu_torch.phy import Demapper, Mapper
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc import lifted_grad as lg
from sionna_tpu_torch.phy.utils import ebnodb2no

torch.set_num_threads(2)
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


_ENCODERS = {}


def _encoders(k, n):
    """(JAX, port) LDPC5GEncoder(k, n), built once per code."""
    if (k, n) not in _ENCODERS:
        _ENCODERS[k, n] = (jldpc.LDPC5GEncoder(k, n), LDPC5GEncoder(k, n))
    return _ENCODERS[k, n]


def _op_by_op(fn, *args):
    """fn(*args) with every JAX operation dispatched on its own (no XLA
    program to compile), as numpy."""
    with jax.disable_jit():
        return np.asarray(fn(*map(jnp.asarray, args)))


def _jax_grad(k, n, cn_update, schedule, num_iter, llr, w):
    """jax.grad of sum(w * dec(llr)) through JAX's lifted engine."""
    dec = jldpc.LDPC5GDecoder(_encoders(k, n)[0], cn_update=cn_update,
                              cn_schedule=schedule, hard_out=False,
                              num_iter=num_iter, engine="lifted")
    return _op_by_op(jax.grad(lambda x, w: jnp.sum(w * dec(x))), llr, w)


def _case_grads(k, n, cn_update, schedule, num_iter):
    """(llr, w, JAX's gradient) of a case of GRAD_CASES."""
    llr, w = _llrs(n, k, seed=num_iter + len(cn_update))
    return llr, w, _jax_grad(k, n, cn_update, schedule, num_iter, llr, w)


def _port_grad(k, n, cn_update, schedule, num_iter, llr, w):
    dec = LDPC5GDecoder(_encoders(k, n)[1], cn_update=cn_update,
                        cn_schedule=schedule, hard_out=False,
                        num_iter=num_iter, engine="lifted")
    x = torch.tensor(llr, requires_grad=True)
    (torch.as_tensor(w) * dec(x)).sum().backward()
    return x.grad.numpy()


def _llrs(n, k, seed, batch=3):
    rng = np.random.default_rng(seed)
    llr = (3 * rng.normal(size=(batch, n)) + 1).astype(np.float32)
    w = rng.normal(size=(batch, k)).astype(np.float32)
    return llr, w


def _tie_llrs(n, k):
    """Every channel LLR of magnitude 2: the min-sum check nodes see tied
    minima (and the filler bits' clipped 20s tie the clip)."""
    rng = np.random.default_rng(3)
    llr = (2 * np.sign(rng.normal(size=(3, n)))).astype(np.float32)
    return llr, rng.normal(size=(3, k)).astype(np.float32)


# (k, n, cn_update, schedule, num_iter): each rule under each schedule;
# the BG2 code k=100, n=200 (58 base edges: ragged masks, punctured bits)
# and one BG1 code (k=396, n=440, 79 base edges, for the tanh rule's
# flooding cases). Flooding boxplus at BP-5 is the link's case.
GRAD_CASES = [
    (396, 440, "boxplus", "flooding", 1),
    (396, 440, "boxplus-phi", "flooding", 1),
    (100, 200, "minsum", "flooding", 1),
    (100, 200, "offset-minsum", "flooding", 1),
    (100, 200, "boxplus", "flooding", 0),
    (100, 200, "boxplus", "layered", 1),
    (100, 200, "boxplus-phi", "layered", 1),
    (100, 200, "minsum", "layered", 5),
    (100, 200, "offset-minsum", "layered", 1),
    (100, 200, "minsum", "layered", 0),
]


@pytest.mark.parametrize("k,n,cn_update,schedule,num_iter", GRAD_CASES)
def test_decoder_gradients_match_jax(k, n, cn_update, schedule, num_iter):
    """d sum(w * dec(llr)) / d llr, LDPC5GDecoder(hard_out=False) on the
    lifted engine, against jax.grad through JAX's: 1e-4 of the largest
    gradient."""
    llr, w, want = _case_grads(k, n, cn_update, schedule, num_iter)
    got = _port_grad(k, n, cn_update, schedule, num_iter, llr, w)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"{cn_update} {schedule} BP-{num_iter} (k={k}, n={n}): "
          f"max|grad| {scale:.4g}, max err {err:.3g} ({err / scale:.3g})")
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def test_minsum_tie_gradient_matches_jax():
    """Every channel LLR of magnitude 2 (``_tie_llrs``), flooding min-sum
    BP-1: the check nodes see tied minima (and the filler bits' clipped
    20s tie the clip), where JAX's jnp.minimum chains and jnp.clip split
    the gradient 1/2 per tie. The port's reverse takes the same rule;
    torch's autograd of the decode (clamp passing 1 at the bound) would
    not."""
    k, n, it = 100, 200, 1
    llr, w = _tie_llrs(n, k)
    want = _jax_grad(k, n, "minsum", "flooding", it, llr, w)
    got = _port_grad(k, n, "minsum", "flooding", it, llr, w)
    scale = np.abs(want).max()
    print(f"ties: max|grad| {scale:.4g}, max err "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)
    # the ties are there: check nodes whose smallest input magnitude
    # comes twice in the first iteration
    dec = LDPC5GDecoder(LDPC5GEncoder(k, n), cn_update="minsum",
                        hard_out=False, num_iter=it)
    _, tape = lg.flooding_tape_forward(
        dec.lifted, dec.recover_llrs(torch.as_tensor(llr)), it)
    tied = 0
    for row in dec.lifted._row_edges.values():
        mags = torch.stack([tape[0, e].abs() for e in row])
        tied += int(((mags == mags.min(0).values).sum(0) > 1).sum())
    assert tied > 0


def test_link_constellation_gradient_matches_jax():
    """d loss / d points of a trainable 16-QAM constellation through
    mapper, AWGN, APP demapper and LDPC5GDecoder(1024 -> 2048 cut to
    k=100, n=200, boxplus, BP-5, hard_out=False) with the loss the BCE of
    the info bits against the decoder's soft output; the bits and the
    noise drawn by JAX and fed to both packages. 1e-4 of the largest
    gradient (torch's gradient is the conjugate of JAX's)."""
    k, n, nbps, batch = 100, 200, 4, 3
    no = float(ebnodb2no(3.0, nbps, k / n))
    key_b, key_n = jax.random.split(jax.random.PRNGKey(7))
    u = np.asarray(jax.random.bernoulli(key_b, 0.5, (batch, k)), np.float32)
    noise = np.asarray(jax.random.normal(key_n, (batch, n // nbps, 2)),
                       np.float32) * np.float32(np.sqrt(no / 2))
    noise_c = noise[..., 0] + 1j * noise[..., 1]
    points0 = jphy.Constellation("qam", nbps).points
    points0 = np.asarray(points0, np.complex64)

    jenc = jldpc.LDPC5GEncoder(k, n)
    jdec = jldpc.LDPC5GDecoder(jenc, cn_update="boxplus", hard_out=False,
                               num_iter=5)
    jmap = jphy.Mapper("qam", nbps)
    jdem = jphy.Demapper("app", "qam", nbps)

    def jax_loss(points):
        pts = points / jnp.sqrt(jnp.mean(jnp.abs(points) ** 2))
        y = jmap(jenc(jnp.asarray(u)), points=pts) + jnp.asarray(noise_c)
        llr = jdem(y, no, points=pts)
        out = jdec(llr)
        return jnp.mean(jax.nn.softplus(-(2 * jnp.asarray(u) - 1) * out))

    want = np.conj(_op_by_op(jax.grad(jax_loss), points0))

    enc = LDPC5GEncoder(k, n)
    dec = LDPC5GDecoder(enc, cn_update="boxplus", hard_out=False,
                        num_iter=5)
    mapper, demapper = Mapper("qam", nbps), Demapper("app", "qam", nbps)
    points = torch.tensor(points0, requires_grad=True)
    pts = points / torch.sqrt(torch.mean(torch.abs(points) ** 2))
    ut = torch.as_tensor(u)
    y = mapper(enc(ut), points=pts) + torch.as_tensor(noise_c)
    out = dec(demapper(y, torch.tensor(no), points=pts))
    loss = torch.mean(F.softplus(-(2 * ut - 1) * out))
    loss.backward()
    got = points.grad.numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"link d loss / d points: max|grad| {scale:.4g}, max err "
          f"{err:.3g} ({err / scale:.3g})")
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("cn_update", ["boxplus", "minsum",
                                       "offset-minsum"])
def test_grad_forward_equals_no_grad_forward(schedule, cn_update):
    """The decode under grad (the tape forward) gives the no-grad
    decode's marginals bit for bit, and its tape holds what the decode
    reads in each iteration."""
    k, n, it = 100, 200, 4
    dec = LDPC5GDecoder(LDPC5GEncoder(k, n), cn_update=cn_update,
                        cn_schedule=schedule, hard_out=False, num_iter=it,
                        engine="lifted")
    llr, _ = _llrs(n, k, seed=11)
    x = torch.as_tensor(llr)
    with torch.no_grad():
        want = dec(x)
    got = dec(x.clone().requires_grad_())
    assert torch.equal(got.detach(), want)
    llr_int = dec.recover_llrs(x)
    lifted = dec.lifted
    marg = lifted(llr_int.clone().requires_grad_(), it,
                  layered=schedule == "layered")
    assert type(marg.grad_fn).__name__ == "LiftedBPFunctionBackward"
    if schedule == "flooding":
        marg, tape = lg.flooding_tape_forward(lifted, llr_int, it)
        assert torch.equal(marg, lifted.decode(llr_int, it))
        assert tape.shape == (it, len(lifted._edges), 3, lifted._z)
        # iteration 0 reads the clipped LLRs in CN alignment
        llr_vn = lg._llr_vn(lifted, llr_int)
        for e, (_, c, s) in enumerate(lifted._edges):
            assert torch.equal(tape[0, e], torch.roll(
                torch.clamp(llr_vn[:, c], -20., 20.), -s, dims=-1))
    else:
        marg, tape_m, tape_c = lg.layered_tape_forward(lifted, llr_int, it)
        assert torch.equal(marg, lifted.decode_layered(llr_int, it))
        m1, _, _ = lg.layered_tape_forward(lifted, llr_int, 1)
        assert torch.equal(tape_m[1].permute(1, 0, 2).reshape(3, -1)[
            :, :lifted._num_vns], m1)
        assert not bool(tape_c[0].any())


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("cn_mode", ["boxplus", "minsum"])
def test_plain_reverse_gradcheck_float64(layered, cn_mode):
    """torch.autograd.gradcheck of LiftedBPFunction (the plain tape
    forward and reverse) in float64 on a small code (k=24, n=48), 3
    iterations, LLRs away from the clip and (min-sum) from ties; in
    gradcheck's fast mode (a random projection of the Jacobian)."""
    enc = LDPC5GEncoder(24, 48)
    dec = LDPC5GDecoder(enc, cn_update=cn_mode, hard_out=False)
    lifted = dec.lifted.double()
    rng = np.random.default_rng(5)
    llr = torch.tensor(rng.uniform(0.5, 3.0, size=(2, lifted._num_vns))
                       * rng.choice([-1., 1.], size=(2, lifted._num_vns)),
                       dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: lg.lifted_bp_grad(lifted, x, 3, layered), (llr,),
        eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)


@pytest.mark.parametrize("knobs", [dict(storage_dtype=torch.bfloat16),
                                   dict(atanh_form="ratio")])
def test_pallas_only_knobs_raise_under_grad(knobs):
    """bf16 storage and the ratio form exist only in the JAX package's
    Pallas kernel, which has no gradient: under grad they raise; without
    grad they decode."""
    dec = LDPC5GDecoder(LDPC5GEncoder(100, 200), hard_out=False)
    llr_int = dec.recover_llrs(torch.as_tensor(_llrs(200, 100, 1)[0]))
    with pytest.raises(RuntimeError, match="Pallas kernel"):
        dec.lifted(llr_int.clone().requires_grad_(), 2, **knobs)
    with torch.no_grad():
        out = dec.lifted(llr_int.clone().requires_grad_(), 2, **knobs)
    assert out.shape == llr_int.shape


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The tape kernels' wrappers and ``_check_llrs`` refuse a CPU tensor
    (the plain pair is the CPU path), and the tape kernels refuse a code
    whose edges are not numbered row by row (a row position of K1's and
    K3's plans is an edge's index in the tapes)."""
    dec = LDPC5GDecoder(LDPC5GEncoder(100, 200))
    lifted = dec.lifted
    x = torch.zeros(2, lifted._num_vns)
    for fn in (lg.flooding_tape_cuda, lg.layered_tape_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(lifted, x, 2)
    from sionna_tpu_torch.phy.fec.ldpc.decoding import (_check_llrs,
                                                        LIFTED_BP_KERNEL)
    with pytest.raises(ValueError, match="CUDA"):
        _check_llrs(LIFTED_BP_KERNEL, lifted, x, 2, None, "log1p")
    swapped = copy.copy(lifted)
    rows = dict(lifted._row_edges)
    rows[0], rows[1] = rows[1], rows[0]
    swapped._row_edges = rows
    for fn, name in ((lg.flooding_tape_cuda, "K5f"),
                     (lg.layered_tape_cuda, "K5Lf")):
        with pytest.raises(ValueError, match=f"{name} takes edges numbered "
                                             "row by row"):
            fn(swapped, x, 2)


@pytest.mark.parametrize("layered", [False, True])
def test_cuda_kernels_match_plain(layered):
    """On a card: K5f (K5Lf) bit-identical to K1 (K3), and K5b (K5Lb)
    within 1e-5 of the largest gradient of the plain reverse on the same
    tape, for the four check-node rules at 0, 1 and 5 iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for cn in ("boxplus", "boxplus-phi", "minsum", "offset-minsum"):
        dec = LDPC5GDecoder(LDPC5GEncoder(100, 200, device=dev),
                            cn_update=cn, engine="lifted", device=dev)
        lifted = dec.lifted
        llr = torch.as_tensor(_llrs(lifted._num_vns, 1, 2, batch=8)[0],
                              device=dev)
        g = torch.randn(llr.shape, device=dev)
        for it in (0, 1, 5):
            if layered:
                marg, tm, tc = lg.layered_tape_cuda(lifted, llr, it)
                with torch.no_grad():
                    assert torch.equal(marg, lifted(llr, it, layered=True))
                got = lg.layered_reverse_cuda(lifted, llr, tm, tc, g)
                want = lg.layered_reverse(lifted, llr, tm, tc, g)
            else:
                marg, tape = lg.flooding_tape_cuda(lifted, llr, it)
                with torch.no_grad():
                    assert torch.equal(marg, lifted(llr, it))
                got = lg.flooding_reverse_cuda(lifted, llr, tape, g)
                want = lg.flooding_reverse(lifted, llr, tape, g)
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-5 * scale
