"""The flagship link (bench.py's TDL-A OFDM link) as a whole, port
against the JAX package at a small width: fft_size=64 (so n=3072,
k=1536), batch 4. The same bits, the same JAX-drawn TDL-A channel and
the same noise go through both chains, from the LDPC encoder to the
decoder; the LLRs into the decoder agree to f32 rounding, and the error
counts are identical with the published decoder (boxplus BP-20,
flooding) and with the layered schedule (10 iterations). The receiver
variants of phase 14 of chip_smoke.py (linear, time-averaged linear and
LMMSE interpolation; LMMSE, ZF and MF equalization) are held through
their LLRs."""

import functools

import numpy as np
import pytest
import torch

import jax

import sionna_tpu.phy as jphy
import sionna_tpu.phy.channel as jch
import sionna_tpu.phy.fec.interleaving as jil
import sionna_tpu.phy.fec.ldpc as jldpc
import sionna_tpu.phy.mimo as jmimo
import sionna_tpu.phy.ofdm as jofdm
from sionna_tpu.phy.channel.tr38901 import TDL as JTDL
from sionna_tpu_torch.phy import BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.channel import ApplyOFDMChannel, OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import TDL
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RowColumnInterleaver)
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.mimo import StreamManagement
import sionna_tpu_torch.phy.ofdm as tofdm
from sionna_tpu_torch.phy.ofdm import (LMMSEEqualizer, LSChannelEstimator,
                                       ResourceGrid, ResourceGridMapper)
from sionna_tpu_torch.phy.utils import ebnodb2no, sim_ber
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

NBPS, FFT, BATCH = 4, 64, 4
RG = dict(num_ofdm_symbols=14, fft_size=FFT, subcarrier_spacing=30e3,
          num_tx=1, num_streams_per_tx=1, cyclic_prefix_length=16,
          pilot_pattern="kronecker", pilot_ofdm_symbol_indices=[2, 11])
# Received grid: one complex product per RE, so ~1 ULP of |y|.
Y_ATOL = 1e-5
# LLRs into the decoder: LS (complex division), LMMSE (JAX's plane path
# against the port's generic algebra) and the demapper's logaddexp each
# round differently in the last place: measured below 4e-6 relative at
# |LLR| <= ~30, so 1e-5 relative is a few ULP of f32.
LLR_RTOL, LLR_ATOL = 1e-5, 1e-4


def _port_link(decoder_kw):
    rg = ResourceGrid(**RG)
    n = rg.num_data_symbols * NBPS
    enc = LDPC5GEncoder(n // 2, n)
    il = RowColumnInterleaver(row_depth=NBPS)
    blocks = dict(rg=rg, enc=enc, il=il, dil=Deinterleaver(il),
                  mapper=Mapper("qam", NBPS), rgm=ResourceGridMapper(rg),
                  est=LSChannelEstimator(rg, interpolation_type="nn"),
                  equ=LMMSEEqualizer(rg, StreamManagement(np.array([[1]]),
                                                          1)),
                  dem=Demapper("app", "qam", NBPS))
    blocks["dec"] = LDPC5GDecoder(enc, hard_out=True, cn_update="boxplus",
                                  **decoder_kw)
    return blocks


@functools.lru_cache(maxsize=None)
def _jax_link():
    """The JAX chain, jitted once for every case."""
    rg = jofdm.ResourceGrid(**RG)
    n = rg.num_data_symbols * NBPS
    enc = jldpc.LDPC5GEncoder(n // 2, n)
    il = jil.RowColumnInterleaver(row_depth=NBPS)
    dil = jil.Deinterleaver(il)
    mapper, dem = jphy.Mapper("qam", NBPS), jphy.Demapper("app", "qam", NBPS)
    rgm = jofdm.ResourceGridMapper(rg)
    est = jofdm.LSChannelEstimator(rg, interpolation_type="nn")
    equ = jofdm.LMMSEEqualizer(rg, jmimo.StreamManagement(np.array([[1]]),
                                                          1))
    flood = jldpc.LDPC5GDecoder(enc, hard_out=True, cn_update="boxplus",
                                num_iter=20, engine="lifted")
    layered = jldpc.LDPC5GDecoder(enc, hard_out=True, cn_update="boxplus",
                                  num_iter=10, cn_schedule="layered",
                                  engine="lifted")

    @jax.jit
    def run(b, h, noise, no):
        x = rgm(mapper(il(enc(b))))
        y = jch.ApplyOFDMChannel()(x, h) + noise
        h_hat, err_var = est(y, no)
        x_hat, no_eff = equ(y, h_hat, err_var, no)
        llr = dil(dem(x_hat, no_eff))
        return x, y, llr, flood(llr), layered(llr)

    return rg, run


# on this channel draw: 7.5 dB, every block fails (hundreds of bit
# errors, the same in both packages); 8 dB, one of the four fails
@pytest.mark.parametrize("ebno_db", [7.5, 8.0])
def test_flagship_link_matches_jax(ebno_db):
    jrg, jrun = _jax_link()
    flood = _port_link(dict(num_iter=20))
    layered = _port_link(dict(num_iter=10, cn_schedule="layered",
                              engine="pallas"))
    k = flood["enc"].k
    rng = np.random.default_rng(int(ebno_db))
    b = rng.integers(0, 2, (BATCH, 1, 1, k)).astype(np.float32)
    # the channel drawn by JAX's TDL-A with normalize_channel=True
    h = np.array(jch.GenerateOFDMChannel(
        JTDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3), jrg,
        normalize_channel=True)(BATCH, key=jax.random.PRNGKey(7)))
    no = np.float32(ebnodb2no(ebno_db, NBPS, 0.5, flood["rg"]))
    noise = ((rng.normal(size=(BATCH, 1, 1, 14, FFT))
              + 1j * rng.normal(size=(BATCH, 1, 1, 14, FFT)))
             * np.sqrt(no / 2)).astype(np.complex64)
    jx, jy, jllr, jflood, jlayered = (np.asarray(v) for v in jrun(
        b, h, noise, no))

    p = flood
    x = p["rgm"](p["mapper"](p["il"](p["enc"](torch.as_tensor(b)))))
    y = ApplyOFDMChannel()(x, torch.as_tensor(h)) + torch.as_tensor(noise)
    h_hat, err_var = p["est"](y, torch.tensor(no))
    x_hat, no_eff = p["equ"](y, h_hat, err_var, torch.tensor(no))
    llr = p["dil"](p["dem"](x_hat, no_eff))
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=Y_ATOL)
    assert llr.shape == jllr.shape == (BATCH, 1, 1, p["enc"].n)
    np.testing.assert_allclose(llr.numpy(), jllr, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
    for port, want in ((flood, jflood), (layered, jlayered)):
        b_hat = port["dec"](llr).numpy()
        assert b_hat.shape == b.shape
        assert int((b_hat != b).sum()) == int((want != b).sum())
        assert int((b_hat != b).any(-1).sum()) == \
            int((want != b).any(-1).sum())


def test_flagship_link_through_sim_ber():
    """The port's own chain (TDL-A and noise from the torch generator)
    through sim_ber, in both schedules: BLER 1 below the waterfall and
    near 0 above it."""
    gen = torch.Generator().manual_seed(0)
    src = BinarySource()
    for kw in (dict(num_iter=20),
               dict(num_iter=10, cn_schedule="layered", engine="pallas")):
        p = _port_link(kw)
        chan = OFDMChannel(TDL("A", 100e-9, 3.5e9, min_speed=3,
                               max_speed=3), p["rg"], normalize_channel=True)

        def mc_fun(batch_size, ebno_db, p=p, chan=chan):
            no = ebnodb2no(ebno_db, NBPS, 0.5, p["rg"])
            b = src([batch_size, 1, 1, p["enc"].k], generator=gen)
            y = chan(p["rgm"](p["mapper"](p["il"](p["enc"](b)))), no,
                     generator=gen)
            h_hat, err_var = p["est"](y, no)
            x_hat, no_eff = p["equ"](y, h_hat, err_var, no)
            return b, p["dec"](p["dil"](p["dem"](x_hat, no_eff)))

        _, bler = sim_ber(mc_fun, [3.0, 14.0], batch_size=16, max_mc_iter=2,
                          early_stop=False, verbose=False)
        assert bler[0] == 1.0 and bler[1] <= 0.1


# The receiver variants that the channel-estimation tutorial compares
# (chip_smoke.py phase 14 runs them at full width): (estimator,
# equalizer), the estimator an interpolation type or "lmmse" for
# LMMSEInterpolator("t-f") from the TDL-A covariances.
RECEIVERS = {"a": ("lin", "lmmse"), "b": ("lin_time_avg", "zf"),
             "c": ("lmmse", "lmmse"), "d": ("nn", "mf")}


def _receiver(pkg, rg, sm, variant):
    """(estimator, equalizer) of ``variant`` from OFDM package ``pkg``
    (the JAX package's or the port's)."""
    interp, eq = RECEIVERS[variant]
    if interp == "lmmse":
        cov_f = pkg.tdl_freq_cov_mat("A", 30e3, FFT, 100e-9)
        cov_t = pkg.tdl_time_cov_mat("A", 3 / 3.6, 3.5e9,
                                     rg.ofdm_symbol_duration, 14)
        est = pkg.LSChannelEstimator(rg, interpolator=pkg.LMMSEInterpolator(
            rg.pilot_pattern, cov_t, cov_f, order="t-f"))
    else:
        est = pkg.LSChannelEstimator(rg, interpolation_type=interp)
    equ = {"lmmse": pkg.LMMSEEqualizer, "zf": pkg.ZFEqualizer,
           "mf": pkg.MFEqualizer}[eq](rg, sm)
    return est, equ


@pytest.mark.parametrize("variant", sorted(RECEIVERS))
def test_flagship_receivers_match_jax(variant):
    """Each receiver variant of the flagship on the same received grid
    (the port's transmitter, bit-exact against JAX's in
    test_flagship_link_matches_jax, through a JAX-drawn TDL-A channel
    plus noise at 8 dB): the LLRs into the decoder agree to f32 rounding
    (the LMMSE interpolation runs in f64 in both packages)."""
    p = _port_link(dict(num_iter=20))
    jrg = jofdm.ResourceGrid(**RG)
    rng = np.random.default_rng(20)
    b = rng.integers(0, 2, (BATCH, 1, 1, p["enc"].k)).astype(np.float32)
    h = np.array(jch.GenerateOFDMChannel(
        JTDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3), jrg,
        normalize_channel=True)(BATCH, key=jax.random.PRNGKey(8)))
    no = np.float32(ebnodb2no(8.0, NBPS, 0.5, p["rg"]))
    noise = ((rng.normal(size=(BATCH, 1, 1, 14, FFT))
              + 1j * rng.normal(size=(BATCH, 1, 1, 14, FFT)))
             * np.sqrt(no / 2)).astype(np.complex64)
    x = p["rgm"](p["mapper"](p["il"](p["enc"](torch.as_tensor(b)))))
    y = (ApplyOFDMChannel()(x, torch.as_tensor(h))
         + torch.as_tensor(noise)).numpy()

    jest, jequ = _receiver(jofdm, jrg,
                           jmimo.StreamManagement(np.array([[1]]), 1),
                           variant)
    jdem = jphy.Demapper("app", "qam", NBPS)
    jdil = jil.Deinterleaver(jil.RowColumnInterleaver(row_depth=NBPS))

    @jax.jit
    def jrx(y):
        h_hat, err_var = jest(y, no)
        x_hat, no_eff = jequ(y, h_hat, err_var, no)
        return jdil(jdem(x_hat, no_eff))

    test, tequ = _receiver(tofdm, p["rg"],
                           StreamManagement(np.array([[1]]), 1), variant)
    h_hat, err_var = test(torch.as_tensor(y), torch.tensor(no))
    x_hat, no_eff = tequ(torch.as_tensor(y), h_hat, err_var,
                         torch.tensor(no))
    llr = p["dil"](p["dem"](x_hat, no_eff))
    want = np.asarray(jrx(y))
    assert llr.shape == want.shape == (BATCH, 1, 1, p["enc"].n)
    np.testing.assert_allclose(llr.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
