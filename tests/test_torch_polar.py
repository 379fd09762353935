"""Polar codes of the PyTorch port against the JAX package: the
construction helpers and both encoders bit-exact (goldens in
``tests/codes/polar`` and JAX, uplink and downlink, with repetition,
puncturing and shortening), the SC decoders' decisions identical to the
goldens, to JAX's and to the port's per-bit SC, the SCL decoders' lists
identical to JAX's (with and without SPC pruning, per bit, and with
deliberately tied path metrics) with their path metrics within a stated
tolerance, the BP decoder's soft output within a stated tolerance, and
the 5G decoder's decisions and CRC status identical.

The JAX side runs small codes (n <= 128 for SCL), each decoder as one
jitted program."""

from pathlib import Path
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.fec.polar as jp
import sionna_tpu.phy.fec.polar.decoding as jdec
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec import polar as tp
from sionna_tpu_torch.phy.fec.polar import decoding as tdec
from sionna_tpu_torch.phy.utils import load_numpy_state

torch.set_num_threads(2)

CODES = Path(__file__).resolve().parent / "codes" / "polar"
# path metrics: sums of up to n softplus terms, whose f32 rounding
# differs between XLA:CPU's exp/log1p and torch's
PM_RTOL = 1e-5
# BP soft outputs: 20 iterations of boxplus on +-30 clipped messages,
# against the largest output magnitude
BP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _mask(frozen_pos, n):
    mask = np.zeros(n, np.float32)
    mask[frozen_pos] = 1
    return mask


def _noisy(c, snr, seed):
    """Classic-convention LLRs of codewords ``c`` (BPSK, noise std 1,
    amplitude ``snr``)."""
    rng = np.random.default_rng(seed)
    return (2 * ((1 - 2 * c) * snr + rng.normal(size=c.shape))).astype(
        np.float32)


def _codewords(k, n, batch, seed):
    frozen, _ = tp.generate_5g_ranking(k, n)
    b = np.random.default_rng(seed).integers(0, 2, (batch, k)).astype(
        np.float32)
    return frozen, b, tp.PolarEncoder(frozen, n)(torch.as_tensor(b)).numpy()


def test_polar_utils_match_jax():
    for k, n in [(0, 32), (16, 32), (100, 256), (512, 1024), (1024, 1024)]:
        for sort in (True, False):
            for got, want in zip(tp.generate_5g_ranking(k, n, sort=sort),
                                 jp.generate_5g_ranking(k, n, sort=sort)):
                np.testing.assert_array_equal(got, want)
    for m in range(7):
        np.testing.assert_array_equal(tp.generate_polar_transform_mat(m),
                                      jp.generate_polar_transform_mat(m))
    for r, m in [(0, 3), (1, 3), (2, 5), (3, 6)]:
        got, want = tp.generate_rm_code(r, m), jp.generate_rm_code(r, m)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    frozen, _ = tp.generate_5g_ranking(16, 32)
    for a, b in zip(tp.generate_dense_polar(frozen, 32, verbose=False),
                    jp.generate_dense_polar(frozen, 32, verbose=False)):
        np.testing.assert_array_equal(a, b)
    for args, err in (((1.5, 32), TypeError), ((-1, 32), ValueError),
                      ((8, 2048), ValueError), ((8, 16), ValueError),
                      ((40, 32), ValueError), ((8, 48), ValueError)):
        with pytest.raises(err):
            tp.generate_5g_ranking(*args)
    with pytest.raises(ValueError):
        tp.generate_rm_code(4, 3)


def test_polar_encoder_matches_jax_and_dense():
    frozen, b, c = _codewords(32, 64, 10, seed=0)
    u = np.zeros((10, 64))
    u[:, np.setdiff1d(np.arange(64), frozen)] = b
    np.testing.assert_array_equal(c, (u @ tp.generate_polar_transform_mat(6))
                                  % 2)
    np.testing.assert_array_equal(
        c, np.asarray(jax.jit(jp.PolarEncoder(frozen, 64))(jnp.asarray(b))))
    enc = tp.PolarEncoder(frozen, 64)
    assert (enc.k, enc.n) == (32, 64)
    np.testing.assert_array_equal(enc.frozen_pos, frozen)
    with pytest.raises(ValueError):
        enc(torch.zeros(2, 31))
    with pytest.raises(ValueError):
        tp.PolarEncoder(frozen, 48)
    with pytest.raises(TypeError):
        tp.PolarEncoder(np.array([0.5]), 64)


@pytest.mark.parametrize("name", ["E45_k30_K41", "E70_k32_K43",
                                  "E127_k29_K40", "E1023_k400_K411",
                                  "E70_k28_K39"])
def test_polar5g_encoder_golden(name):
    u = np.load(CODES / f"{name}_u.npy")
    c_ref = np.load(CODES / f"{name}_c.npy")
    enc = tp.Polar5GEncoder(u.shape[1], c_ref.shape[1])
    np.testing.assert_array_equal(
        enc(torch.as_tensor(u, dtype=torch.float32)).numpy(), c_ref)


# (k, n, channel type): no rate matching, repetition, puncturing,
# shortening, on the uplink and the downlink
RM_CASES = {"plain": (100, 256, "uplink"), "repeat": (20, 300, "uplink"),
            "puncture": (30, 200, "uplink"), "shorten": (200, 250, "uplink"),
            "dl_repeat": (8, 300, "downlink"),
            "dl_puncture": (20, 120, "downlink"),
            "dl_shorten": (100, 140, "downlink")}


@pytest.mark.parametrize("case", list(RM_CASES))
def test_polar5g_encoder_matches_jax(case):
    """Codewords and the rate-matching structure bit-exact; the
    structure exported from JAX loads into the port's encoder."""
    k, n, channel = RM_CASES[case]
    te = tp.Polar5GEncoder(k, n, channel_type=channel)
    je = jp.Polar5GEncoder(k, n, channel_type=channel)
    regime = ("repeat" if n > te.n_polar else "plain" if n == te.n_polar
              else "puncture" if te.k_polar / n <= 7 / 16 else "shorten")
    assert case.endswith(regime)
    b = np.random.default_rng(7).integers(0, 2, (3, 2, k)).astype(np.float32)
    got = te(torch.as_tensor(b))
    assert got.shape == (3, 2, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.jit(je)(jnp.asarray(b))))
    assert (te.k_polar, te.n_polar, te.k, te.n) == \
        (je.k_polar, je.n_polar, je.k, je.n)
    exported = {"frozen_pos": je.frozen_pos,
                "ind_rate_matching": je._ind_rate_matching,
                "enc_crc.parity_matrix": je.enc_crc._get_pmat(k)}
    if channel == "downlink":
        exported["ind_input_int"] = je._ind_input_int
    load_numpy_state(te, exported)
    bad = je._ind_rate_matching.copy()
    bad[[0, 1]] = bad[[1, 0]]
    with pytest.raises(ValueError, match="ind_rate_matching"):
        load_numpy_state(te, {**exported, "ind_rate_matching": bad})


@pytest.mark.parametrize("name", ["P_128_37", "P_128_110", "P_256_128"])
def test_sc_decoder_golden(name):
    a_vec = np.load(CODES / f"{name}_Avec.npy")
    llr_ch = np.load(CODES / f"{name}_Lch.npy")
    u_hat_ref = np.load(CODES / f"{name}_uhat.npy")
    dec = tp.PolarSCDecoder(np.where(a_vec == 0)[0], len(a_vec))
    np.testing.assert_array_equal(
        dec(torch.as_tensor(-llr_ch, dtype=torch.float32)).numpy(), u_hat_ref)


@pytest.mark.parametrize("k,n", [(32, 64), (64, 128)])
def test_fast_sc_matches_jax_and_per_bit(k, n):
    """Fast SSC: the port's decisions equal JAX's and the port's per-bit
    SC's on moderate-SNR blocks; the decoder's info bits are JAX's."""
    frozen, b, c = _codewords(k, n, 32, seed=k)
    llr = _noisy(c, 1.0, seed=n)
    mask = _mask(frozen, n)
    fast = tdec._fast_sc_decode_batch(torch.as_tensor(llr), mask, n)
    per_bit = tdec._sc_decode_single(torch.as_tensor(llr), mask, n)
    np.testing.assert_array_equal(fast.numpy(), per_bit.numpy())
    j_fast = jax.jit(lambda x: jdec._fast_sc_decode_batch(x, mask, n))
    np.testing.assert_array_equal(fast.numpy(),
                                  np.asarray(j_fast(jnp.asarray(llr))))
    u_hat = tp.PolarSCDecoder(frozen, n)(torch.as_tensor(-llr)).numpy()
    np.testing.assert_array_equal(u_hat, fast.numpy()[:, np.setdiff1d(
        np.arange(n), frozen)])
    assert 0 < (u_hat != b).any(-1).mean() < 1  # errors, not all
    if n > 64:
        return
    # the SPC shortcut (exact for min-sum only) runs when asked
    spc = tdec._fast_sc_decode_batch(torch.as_tensor(llr), mask, n,
                                     use_spc=True)
    j_spc = jax.jit(lambda x: jdec._fast_sc_decode_batch(x, mask, n,
                                                         use_spc=True))
    np.testing.assert_array_equal(spc.numpy(),
                                  np.asarray(j_spc(jnp.asarray(llr))))


def _assert_lists_match(got, want, what):
    """Identical decision lists and path metrics within PM_RTOL."""
    (tu, tpm), (ju, jpm) = got, want
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju), err_msg=what)
    np.testing.assert_allclose(tpm.numpy(), np.asarray(jpm), rtol=PM_RTOL,
                               err_msg=what)


@pytest.mark.parametrize("use_spc,k,n", [(False, 32, 64), (True, 64, 128)])
def test_fast_scl_matches_jax(use_spc, k, n):
    """Fast SSCL, L=8 (SPC pruning, the 5G decoder's default, at
    n=128): every path's decisions identical to JAX's, the path metrics
    within PM_RTOL; the decoder returns the best path's info bits."""
    lsz = 8
    frozen, b, c = _codewords(k, n, 16, seed=3)
    llr = _noisy(c, 0.8, seed=4)
    mask = _mask(frozen, n)
    got = tdec._fast_scl_decode_batch(torch.as_tensor(llr), mask, n, lsz,
                                      use_spc=use_spc)
    want = jax.jit(lambda x: jdec._fast_scl_decode_batch(
        x, mask, n, lsz, use_spc=use_spc))(jnp.asarray(llr))
    _assert_lists_match(got, want, f"use_spc={use_spc}")
    dec = tp.PolarSCLDecoder(frozen, n, list_size=lsz, use_spc=use_spc,
                             return_crc_status=True)
    u_hat, status = dec(torch.as_tensor(-llr))
    best = np.argmin(np.asarray(want[1]), -1)
    info = np.setdiff1d(np.arange(n), frozen)
    np.testing.assert_array_equal(
        u_hat.numpy(), np.asarray(want[0])[np.arange(16), best][:, info])
    assert status.all()


def test_per_bit_scl_matches_jax():
    """The per-bit SCL reference (``use_fast_scl=False``) against JAX's,
    and the unpruned tree decoder against it."""
    k, n, lsz = 30, 64, 4
    frozen, _, c = _codewords(k, n, 8, seed=5)
    llr = _noisy(c, 0.8, seed=6)
    mask = _mask(frozen, n)
    got = tdec._scl_decode_single(torch.as_tensor(llr), mask, n, lsz)
    want = jax.jit(jax.vmap(lambda x: jdec._scl_decode_single(
        x, mask, n, lsz)))(jnp.asarray(llr))
    _assert_lists_match(got, want, "per-bit")
    unpruned = tdec._fast_scl_decode_batch(torch.as_tensor(llr), mask, n,
                                           lsz, use_fast=False)
    order_t = torch.argsort(unpruned[1], dim=-1, stable=True)
    order_p = torch.argsort(got[1], dim=-1, stable=True)
    np.testing.assert_array_equal(
        torch.gather(unpruned[0], 1, order_t[..., None].expand(-1, -1, n)),
        torch.gather(got[0], 1, order_p[..., None].expand(-1, -1, n)))
    dec = tp.PolarSCLDecoder(frozen, n, list_size=lsz, use_fast_scl=False)
    best = np.argmin(np.asarray(want[1]), -1)
    np.testing.assert_array_equal(
        dec(torch.as_tensor(-llr)).numpy(),
        np.asarray(want[0])[np.arange(8), best][
            :, np.setdiff1d(np.arange(n), frozen)])


def test_scl_ties_match_jax():
    """Tied path metrics: all-zero LLRs (every fork ties all 2L
    candidates), constant and periodic LLRs (duplicated paths, equal
    |llr| in rate-1 and SPC nodes, saturated +-40). The stable selection
    keeps XLA TopK's lower-index-first order, so the lists are JAX's.
    (Metrics that tie only in exact arithmetic, sums of different terms,
    round differently in the two packages and are not constructed.)"""
    lo, hi = torch.tensor([[3., 1., 3., 1.]]), torch.tensor([[1., 3., 1., 3.]])
    pm, bits, parents = tdec._prune(lo, hi, 4)
    np.testing.assert_array_equal(pm.numpy(), [[1., 1., 1., 1.]])
    np.testing.assert_array_equal(parents.numpy(), [[1, 3, 0, 2]])
    np.testing.assert_array_equal(bits.numpy(), [[0., 0., 1., 1.]])
    k, n = 32, 64
    frozen, _ = tp.generate_5g_ranking(k, n)
    mask = _mask(frozen, n)
    half = n // 2
    llr = np.stack([np.zeros(n), np.ones(n), np.tile([2., 0.], half),
                    np.r_[np.zeros(half), 3 * np.ones(half)],
                    np.r_[-np.ones(half), np.zeros(half)],
                    np.tile([0., 0., 0., 4.], n // 4), 40 * np.ones(n),
                    np.tile([40., -40.], half)]).astype(np.float32)
    for lsz, use_spc in ((4, True), (8, False)):
        got = tdec._fast_scl_decode_batch(torch.as_tensor(llr), mask, n,
                                          lsz, use_spc=use_spc)
        # all-zero LLRs: every path ends tied
        assert (got[1][0] == got[1][0, 0]).all()
        want = jax.jit(lambda x: jdec._fast_scl_decode_batch(
            x, mask, n, lsz, use_spc=use_spc))(jnp.asarray(llr))
        _assert_lists_match(got, want, f"ties, L={lsz}")


def test_bp_decoder_matches_jax():
    """Soft outputs within BP_ATOL of JAX's (the max error is printed),
    identical hard decisions; noiseless codewords decode."""
    k, n = 64, 128
    frozen, b, c = _codewords(k, n, 16, seed=9)
    llr = -_noisy(c, 1.0, seed=10)  # logits
    soft = tp.PolarBPDecoder(frozen, n, num_iter=20, hard_out=False)
    got = soft(torch.as_tensor(llr)).numpy()
    want = np.asarray(jp.PolarBPDecoder(frozen, n, num_iter=20,
                                        hard_out=False)(jnp.asarray(llr)))
    err = np.abs(got - want).max()
    print(f"BP soft output: max |port - JAX| {err:.3e} "
          f"(max |llr| {np.abs(want).max():.1f})")
    assert err < BP_RTOL * np.abs(want).max()
    hard = tp.PolarBPDecoder(frozen, n, num_iter=20)
    assert (hard.num_iter, hard.k) == (20, k)
    np.testing.assert_array_equal(hard(torch.as_tensor(llr)).numpy(),
                                  (want > 0).astype(np.float32))
    clean = (2 * c - 1) * 6.0
    np.testing.assert_array_equal(
        hard(torch.as_tensor(clean, dtype=torch.float32)).numpy(), b)


# 5G decoder cases: (k, n, channel type, Eb/N0-like amplitude)
DEC_CASES = {"ul_repeat": (20, 300, "uplink", 0.4),
             "ul_shorten": (40, 60, "uplink", 1.5),
             "dl_puncture": (20, 120, "downlink", 1.0)}


@pytest.mark.parametrize("case", list(DEC_CASES))
def test_polar5g_decoder_matches_jax(case):
    """SC, SCL (CRC-aided, the default SPC pruning; on the downlink
    through the inverse input interleaver) and BP-10: info bits and CRC
    status identical to JAX's on noisy blocks; the rate recovery sums
    repeated positions in a fixed order. (BP runs 10 iterations: at 20,
    n=256 and this SNR it is chaotic, a 1-ULP change of its input moves
    JAX's own output by several units and flips decisions.)"""
    k, n, channel, amp = DEC_CASES[case]
    te = tp.Polar5GEncoder(k, n, channel_type=channel)
    je = jp.Polar5GEncoder(k, n, channel_type=channel)
    b = np.random.default_rng(11).integers(0, 2, (24, k)).astype(np.float32)
    c = te(torch.as_tensor(b)).numpy()
    llr = -_noisy(c, amp, seed=12)
    # SCL's JAX program at n_polar=256 compiles for seconds: SCL runs on
    # the two smaller mother codes
    for dec_type in ("SC", "SCL", "BP") if te.n_polar <= 128 else ("SC",
                                                                   "BP"):
        td = tp.Polar5GDecoder(te, dec_type=dec_type, list_size=4,
                               num_iter=10, return_crc_status=True)
        jd = jp.Polar5GDecoder(je, dec_type=dec_type, list_size=4,
                               num_iter=10, return_crc_status=True)
        u, status = td(torch.as_tensor(llr))
        ju, jstatus = jax.jit(jd)(jnp.asarray(llr))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju),
                                      err_msg=dec_type)
        np.testing.assert_array_equal(status.numpy(), np.asarray(jstatus),
                                      err_msg=dec_type)
        print(f"{case} {dec_type}: CRC passes {status.float().mean():.3f}")
    assert td.dec_type == "BP"
    # rate recovery: the mother-codeword logits equal JAX's scatter-add
    mother = td.recover_llrs(torch.as_tensor(llr))
    want = np.zeros((24, te.n_polar), np.float32)
    np.add.at(want, (slice(None), je._ind_rate_matching), llr)
    shortened = np.setdiff1d(np.arange(te.n_polar), je._ind_rate_matching)
    if case.endswith("shorten"):
        want[:, shortened] = -30.
    np.testing.assert_allclose(mother.numpy(), want, rtol=1e-6)


def test_scl_decoder_arguments():
    frozen, _ = tp.generate_5g_ranking(32, 64)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tp.PolarSCLDecoder(frozen, 64, use_hybrid_sc=True)
    assert any("no effect" in str(r.message) for r in rec)
    with pytest.raises(ValueError):
        tp.PolarSCLDecoder(frozen, 64, list_size=6)
    with pytest.raises(ValueError):
        tp.PolarSCDecoder(frozen, 48)
    with pytest.raises(TypeError):
        tp.Polar5GDecoder(tp.PolarEncoder(frozen, 64))
    with pytest.raises(ValueError):
        tp.Polar5GDecoder(tp.Polar5GEncoder(32, 64), dec_type="ML")
    dec = tp.PolarSCLDecoder(frozen, 64, list_size=4, crc_degree="CRC11")
    assert (dec.list_size, dec.k_crc, dec.k, dec.n) == (4, 11, 32, 64)
