"""The Pallas kernel's last two knobs in the PyTorch port: the plain
lifted decodes with bf16 message storage (flooding: v2c; layered: c2v)
and with the ratio form of the boxplus magnitude, against JAX's Pallas
kernel ``_lifted_pallas_decode`` in interpret mode on the CPU, at the
(100,200) code (Z=18, six ragged edges), batch 8, 5 iterations (2 for
the layered schedule, whose unclipped posterior passes XLA:CPU's tanh
saturation at |x| > 15.8 after that). Each case is one jitted JAX
program (5-18 s each here).

Tolerances: min-sum uses only abs, min, compare, add and sign products,
and bf16 rounding is round-to-nearest-even in both packages: bit-exact.
Boxplus goes through XLA:CPU's f32 tanh/log1p/log, a few ULP from
torch's; a bf16 store rounds away most of that, but a value that lands
next to a bf16 rounding boundary can round the other way, one bf16 ULP
(2^-8 relative) that the next iterations carry on: each case states its
bound, and the hard decisions must be identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sionna_tpu.phy.fec.ldpc import LDPC5GDecoder as JDec
from sionna_tpu.phy.fec.ldpc import LDPC5GEncoder as JEnc
from sionna_tpu.phy.fec.ldpc.decoding import _lifted_pallas_decode
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc.decoding import (LAYERED_BP_KERNEL,
                                                    LIFTED_BP_KERNEL)
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device

NUM_ITER = 5
LAYERED_ITER = 2


def _decoders(cn):
    je, te = JEnc(100, 200), LDPC5GEncoder(100, 200)
    return (JDec(je, cn_update=cn, engine="lifted")._lifted,
            LDPC5GDecoder(te, cn_update=cn, engine="lifted").lifted)


def _llr_int(lifted, seed=5):
    """[8, num_vns] classic-convention LLRs of noisy random codewords of
    the (100,200) code, through the decoder's rate recovery."""
    enc = LDPC5GEncoder(100, 200)
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, (8, 100)).astype(np.float32)
    c = enc(torch.as_tensor(b)).numpy()
    llr = ((2 * c - 1) * 2.0 + rng.normal(0, 1.4, c.shape)).astype(
        np.float32)
    llr_int = LDPC5GDecoder(enc).recover_llrs(torch.as_tensor(llr))
    assert llr_int.shape[1] == lifted._num_vns
    return llr_int


def _pallas(jl, llr_int, **kw):
    return np.asarray(jax.jit(lambda x: _lifted_pallas_decode(
        jl, x, NUM_ITER, interpret=True, **kw))(jnp.asarray(
            llr_int.numpy())))


def _forward(tl, llr_int, num_iter=NUM_ITER, **kw):
    """The port's counterpart of _lifted_pallas_decode on a CPU tensor:
    the plain decode, no kernel launch."""
    launches = (LIFTED_BP_KERNEL.launches, LAYERED_BP_KERNEL.launches)
    out = tl(llr_int, num_iter, **kw)
    assert (LIFTED_BP_KERNEL.launches, LAYERED_BP_KERNEL.launches) == \
        launches
    return out.numpy()


def test_minsum_bf16_storage_bit_exact():
    jl, tl = _decoders("minsum")
    llr_int = _llr_int(tl)
    want = _pallas(jl, llr_int, storage_dtype=jnp.bfloat16)
    got = _forward(tl, llr_int, storage_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    # the storage rounding is real: f32 storage decodes differently
    assert not np.array_equal(got, tl.decode(llr_int, NUM_ITER).numpy())


def test_boxplus_bf16_storage_matches_pallas():
    """Flooding boxplus with bf16 v2c storage: marginals (|x| <= 20)
    within 1e-3 (measured 1.3e-5; the port's f32 storage is 2.4e-2 away
    from them), identical decisions."""
    jl, tl = _decoders("boxplus")
    llr_int = _llr_int(tl)
    want = _pallas(jl, llr_int, storage_dtype=jnp.bfloat16)
    got = _forward(tl, llr_int, storage_dtype=torch.bfloat16)
    assert np.abs(want - tl.decode(llr_int, NUM_ITER).numpy()).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_boxplus_ratio_form_matches_pallas():
    """Flooding boxplus with the ratio form: marginals within the f32
    boxplus tolerance of the port's lifted tests (1e-4; measured
    1.9e-6), identical decisions; the ratio form moves the port's own
    marginals off the log1p form's by a few ULP (measured 1.9e-6)."""
    jl, tl = _decoders("boxplus")
    llr_int = _llr_int(tl)
    want = _pallas(jl, llr_int, atanh_form="ratio")
    got = _forward(tl, llr_int, atanh_form="ratio")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got > 0, want > 0)
    log1p = _forward(tl, llr_int)
    assert 0 < np.abs(got - log1p).max() < 1e-4


def test_layered_bf16_storage_and_ratio_match_pallas():
    """Layered boxplus, 2 iterations: bf16 c2v storage within 1e-3 of
    the Pallas kernel's (measured 1.5e-5, at |x| <= 27; JAX's own f32
    storage is 1.1e-2 away from it) with identical decisions; the ratio
    form is ignored by the layered schedule in both packages
    (bit-identical to log1p)."""
    jl, tl = _decoders("boxplus")
    llr_int = _llr_int(tl)
    knobs = (dict(storage_dtype=jnp.bfloat16), dict(atanh_form="ratio"),
             dict())
    run = jax.jit(lambda x: [_lifted_pallas_decode(
        jl, x, LAYERED_ITER, interpret=True, layered=True, **kw)
        for kw in knobs])
    want_bf16, want_ratio, want_log1p = (np.asarray(v) for v in run(
        jnp.asarray(llr_int.numpy())))
    np.testing.assert_array_equal(want_ratio, want_log1p)
    assert np.abs(want_bf16 - want_log1p).max() > 1e-3
    got = _forward(tl, llr_int, LAYERED_ITER, layered=True,
                   storage_dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want_bf16, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got > 0, want_bf16 > 0)
    np.testing.assert_array_equal(
        _forward(tl, llr_int, LAYERED_ITER, layered=True,
                 atanh_form="ratio"),
        _forward(tl, llr_int, LAYERED_ITER, layered=True))
