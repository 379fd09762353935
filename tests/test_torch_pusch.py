"""The PUSCH blocks of the PyTorch port against the JAX package and the
stored reference waveforms: the transmitter (every golden waveform, the
time domain, two UEs), ``PUSCHPilotPattern``, ``PUSCHPrecoder``,
``PUSCHLSChannelEstimator`` and the receiver as a whole, held stage by
stage against JAX's blocks at tiny sizes.

JAX's whole ``PUSCHReceiver`` is never compiled (about a minute on the
CPU): its estimator, detector, layer demapper and TB decoder are jitted
one by one and fed what the port's receiver saw (captured with forward
hooks), from the same bits, channel and noise drawn with NumPy. The NR
blocks carry no trainable weights; both packages' configurations come
from the same settings (``test_torch_nr.load_pusch_config``).

Tolerances:
- the transmitter against the stored waveforms: WAVEFORM_ATOL, as in
  ``tests/test_nr.py``; against JAX: equal grids in the frequency
  domain (the same gathers and a 2 x 2 product), TIME_RTOL of the
  largest sample in the time domain (f32 IFFTs, pocketfft in both,
  other butterfly orders);
- the receiver's demodulated grid in the time domain: DEMOD_RTOL of
  the largest value (f32 FFTs of the noisy received signal);
- the precoder: PRECODER_RTOL of the largest output (complex f32
  matrix products summed in other orders);
- the LS estimates and their error variance: EST_RTOL of the largest
  value (the CDM averages and the linear interpolation round alike but
  for the order of sums);
- the LLRs into the TB decoder: LLR_RTOL of the largest LLR (the LMMSE
  solves and the max-log demapper round differently, as in
  ``tests/test_torch_mimo_ofdm.py``); the decisions and the TB CRC flags
  identical.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.nr as jnr
import sionna_tpu_torch.phy.nr as tnr
from sionna_tpu_torch.phy.config import config as torch_config

from test_torch_nr import (CFG_DIR, golden_config, golden_waveform,
                           load_pusch_config)

torch.set_num_threads(2)

WAVEFORM_ATOL = 1e-5
TIME_RTOL = 1e-6
DEMOD_RTOL = 1e-5
PRECODER_RTOL = 1e-6
EST_RTOL = 1e-5
LLR_RTOL = 1e-4
# the golden waveforms with both a configuration and a stored grid (the
# corpus has test_83.json without test_83.npy)
GOLDEN_IDS = sorted(
    int(os.path.basename(p)[5:-5]) for p in
    glob.glob(os.path.join(CFG_DIR, "*.json"))
    if os.path.isfile(p[:-5] + ".npy"))


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("test_id", GOLDEN_IDS)
def test_transmitter_golden(test_id):
    """The port's PUSCHTransmitter on the stored bits against the stored
    frequency-domain waveform."""
    b, grid = golden_waveform(test_id)
    pc = load_pusch_config(tnr.PUSCHConfig, golden_config(test_id))
    tx = tnr.PUSCHTransmitter(pc, return_bits=False)
    x = tx(torch.as_tensor(b.astype(np.float32)))
    assert x.dtype == torch.complex64
    xg = np.transpose(x[0, 0].numpy(), (2, 1, 0)).squeeze()
    np.testing.assert_allclose(xg, grid, rtol=0, atol=WAVEFORM_ATOL)


def tutorial_config(mod, n_size_grid=16, **kw):
    """The PUSCH tutorial's settings (30 kHz, 2 ports, 2 layers, TPMI 1,
    DMRS type 1 with one additional position, MCS 14) at
    ``n_size_grid`` PRBs; ``kw`` overrides DMRS settings."""
    pc = mod.PUSCHConfig()
    pc.carrier.subcarrier_spacing = 30
    pc.carrier.n_size_grid = n_size_grid
    pc.num_antenna_ports = 2
    pc.num_layers = 2
    pc.precoding = "codebook"
    pc.tpmi = 1
    pc.dmrs.config_type = 1
    pc.dmrs.additional_position = 1
    pc.tb.mcs_index = 14
    for name, value in kw.items():
        setattr(pc.dmrs, name, value)
    return pc


def two_ue_configs(mod, n_size_grid=2):
    """Two UEs of 2 layers each on DMRS ports [0, 1] and [2, 3] (CDM
    groups 0 and 1, no data on the DMRS symbols)."""
    pcs = []
    for ports, rnti in (([0, 1], 101), ([2, 3], 202)):
        pc = mod.PUSCHConfig()
        pc.carrier.n_size_grid = n_size_grid
        pc.num_antenna_ports = 2
        pc.num_layers = 2
        pc.dmrs.dmrs_port_set = ports
        pc.n_rnti = rnti
        pc.tb.mcs_index = 10
        pcs.append(pc)
    return pcs


def _configs(case, mod):
    if case == "two_ue":
        return two_ue_configs(mod)
    if case == "golden_19":
        return [load_pusch_config(mod.PUSCHConfig, golden_config(19))]
    return [tutorial_config(mod, 2)]


@pytest.mark.parametrize("case", ["tutorial", "golden_19", "two_ue"])
def test_pilot_pattern_and_precoder_match_jax(case):
    """PUSCHPilotPattern's mask and pilots, and PUSCHPrecoder on random
    layer grids, against JAX's."""
    tpcs, jpcs = _configs(case, tnr), _configs(case, jnr)
    tpp = tnr.PUSCHPilotPattern(tpcs)
    jpp = jnr.PUSCHPilotPattern(jpcs)
    np.testing.assert_array_equal(tpp.mask, np.asarray(jpp.mask))
    assert tpp.pilots.dtype == np.complex64
    np.testing.assert_array_equal(tpp.pilots, np.asarray(jpp.pilots))
    if tpcs[0].precoding != "codebook":
        return
    w = [pc.precoding_matrix for pc in tpcs]
    tpre = tnr.PUSCHPrecoder(w)
    jpre = jnr.PUSCHPrecoder([pc.precoding_matrix for pc in jpcs])
    rng = np.random.default_rng(3)
    shape = (3, len(w), w[0].shape[1], 14, 12 * tpcs[0].num_resource_blocks)
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    got = tpre(torch.as_tensor(x))
    assert got.dtype == torch.complex64
    assert got.shape == (3, len(w), w[0].shape[0]) + shape[3:]
    assert _rel_err(got.numpy(), jpre(jnp.asarray(x))) <= PRECODER_RTOL


@pytest.mark.parametrize("case", ["tutorial", "two_ue"])
def test_transmitter_matches_jax(case):
    """Both transmitters on the same bits: equal frequency-domain grids,
    and time-domain waveforms within TIME_RTOL."""
    tpcs, jpcs = _configs(case, tnr), _configs(case, jnr)
    ttx = tnr.PUSCHTransmitter(tpcs, return_bits=False)
    jtx = jnr.PUSCHTransmitter(jpcs, return_bits=False)
    b = np.random.default_rng(1).integers(
        0, 2, (2, len(tpcs), tpcs[0].tb_size)).astype(np.float32)
    x = ttx(torch.as_tensor(b))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jax.jit(jtx)(
        jnp.asarray(b))))
    ttx = tnr.PUSCHTransmitter(tpcs, return_bits=False,
                               output_domain="time")
    jtx = jnr.PUSCHTransmitter(jpcs, return_bits=False,
                               output_domain="time")
    got = ttx(torch.as_tensor(b))
    assert got.shape == (2, len(tpcs), tpcs[0].num_antenna_ports,
                         ttx.resource_grid.num_time_samples)
    assert _rel_err(got.numpy(), jax.jit(jtx)(jnp.asarray(b))) <= TIME_RTOL
    # drawn bits: shape and values
    tx = tnr.PUSCHTransmitter(tpcs)
    x, bits = tx(3, generator=torch.Generator().manual_seed(0))
    assert bits.shape == (3, len(tpcs), tpcs[0].tb_size)
    assert set(bits.unique().tolist()) == {0.0, 1.0}


def _received(rng, x, num_rx_ant, no):
    """y of a channel flat in time and frequency per batch element (h
    [b, 1, num_rx_ant, num_tx, num_tx_ant, 1, 1]) plus noise, NumPy."""
    b, num_tx, num_ant = x.shape[:3]
    hs = (b, 1, num_rx_ant, num_tx, num_ant, 1, 1)
    h = ((rng.normal(size=hs) + 1j * rng.normal(size=hs))
         / np.sqrt(2 * num_ant * num_tx)).astype(np.complex64)
    y = np.sum(h * x[:, None, None], axis=(3, 4))
    n = np.sqrt(no / 2) * (rng.normal(size=y.shape)
                           + 1j * rng.normal(size=y.shape))
    return h, (y + n).astype(np.complex64)


@pytest.mark.parametrize("dmrs,interpolation", [
    (dict(length=1, additional_position=1, num_cdm_groups_without_data=1),
     "lin"),
    (dict(length=1, additional_position=0, num_cdm_groups_without_data=2),
     "lin"),
    (dict(length=2, additional_position=0, num_cdm_groups_without_data=1),
     "lin"),
    (dict(length=2, additional_position=1, num_cdm_groups_without_data=2),
     "lin"),
    (dict(length=2, additional_position=1, num_cdm_groups_without_data=2),
     "nn")], ids=["len1-cdm1", "len1-cdm2", "len2-cdm1", "len2-cdm2",
                  "len2-cdm2-nn"])
def test_ls_estimator_matches_jax(dmrs, interpolation):
    """PUSCHLSChannelEstimator against JAX's on the same received grid:
    single and double-symbol DMRS (time averaging), one and two CDM
    groups without data (data REs on the DMRS symbols; pilots zero
    where the other CDM group sends)."""
    tpc, jpc = (tutorial_config(mod, 2, **dmrs) for mod in (tnr, jnr))
    ttx = tnr.PUSCHTransmitter(tpc, return_bits=False)
    jtx = jnr.PUSCHTransmitter(jpc, return_bits=False)
    rng = np.random.default_rng(7)
    b = rng.integers(0, 2, (2, 1, tpc.tb_size)).astype(np.float32)
    x = ttx(torch.as_tensor(b)).numpy()
    _, y = _received(rng, x, 4, 0.05)
    args = (dmrs["length"], dmrs["additional_position"],
            dmrs["num_cdm_groups_without_data"])
    test = tnr.PUSCHLSChannelEstimator(ttx.resource_grid, *args,
                                       interpolation_type=interpolation)
    jest = jnr.PUSCHLSChannelEstimator(jtx.resource_grid, *args,
                                       interpolation_type=interpolation)
    h_hat, err_var = test(torch.as_tensor(y), torch.tensor(0.05))
    jh_hat, jerr_var = jax.jit(jest)(jnp.asarray(y), jnp.float32(0.05))
    assert torch.isfinite(h_hat).all() and torch.isfinite(err_var).all()
    assert h_hat.dtype == torch.complex64 and err_var.dtype == torch.float32
    assert _rel_err(h_hat.numpy(), jh_hat) <= EST_RTOL
    err_var = np.broadcast_to(err_var.numpy(), np.shape(jerr_var))
    assert _rel_err(err_var, jerr_var) <= EST_RTOL


def _capture(module, store, name):
    """Forward hook keeping ``module``'s inputs and output in
    ``store[name]``."""
    def hook(_, args, output):
        store[name] = ([a.detach().numpy() if torch.is_tensor(a) else a
                        for a in args], output)
    return module.register_forward_hook(hook)


def _jax_stages(jrx, y, no, h, perfect):
    """JAX's receiver stages, each jitted alone: (h_hat, llr, b_hat,
    crc)."""
    if perfect:
        h_hat = jnp.asarray(h)
        if jrx._w is not None:  # the precoding of pusch_receiver.py
            h_hat = jnp.transpose(h_hat, (0, 1, 3, 5, 6, 2, 4))
            h_hat = jnp.matmul(h_hat, jnp.asarray(jrx._w, jnp.complex64))
            h_hat = jnp.transpose(h_hat, (0, 1, 5, 2, 6, 3, 4))
        err_var = jnp.zeros((1,) * h_hat.ndim, jnp.float32)
    else:
        h_hat, err_var = jax.jit(jrx._channel_estimator)(y, no)
    llr = jax.jit(jrx._mimo_detector)(y, h_hat, err_var, no)
    llr = jax.jit(jrx._layer_demapper)(llr)
    b_hat, crc = jax.jit(jrx._tb_decoder)(llr)
    return h_hat, llr, b_hat, crc


@pytest.mark.parametrize("case,n_size_grid,csi,domain", [
    ("tutorial", 1, "ls", "time"), ("tutorial", 2, "perfect", "freq"),
    ("tutorial", 3, "ls", "freq"), ("tutorial", 4, "perfect", "freq"),
    ("two_ue", 2, "ls", "freq")])
def test_receiver_matches_jax_stages(case, n_size_grid, csi, domain):
    """The port's PUSCHReceiver as a whole against JAX's stages on the
    same received grid (LS or perfect CSI with the codebook precoding
    applied to h; the time domain through OFDMDemodulator): the channel
    estimate, the LLRs into the TB decoder within LLR_RTOL, and the
    decisions and TB CRC flags identical; at this SNR every TB decodes."""
    if case == "two_ue":
        tpcs, jpcs = two_ue_configs(tnr), two_ue_configs(jnr)
        num_rx_ant = 8
    else:
        tpcs = [tutorial_config(tnr, n_size_grid)]
        jpcs = [tutorial_config(jnr, n_size_grid)]
        num_rx_ant = 4
    kw = dict(output_domain=domain)
    ttx = tnr.PUSCHTransmitter(tpcs, return_bits=False, **kw)
    jtx = jnr.PUSCHTransmitter(jpcs, return_bits=False, **kw)
    rkw = dict(return_tb_crc_status=True, input_domain=domain)
    if domain == "time":
        rkw["l_min"] = 0
    if csi == "perfect":
        rkw["channel_estimator"] = "perfect"
    trx = tnr.PUSCHReceiver(ttx, **rkw)
    jrx = jnr.PUSCHReceiver(jtx, **rkw)

    rng = np.random.default_rng(n_size_grid)
    no = 0.01
    b = rng.integers(0, 2, (4, len(tpcs), tpcs[0].tb_size)).astype(
        np.float32)
    x = ttx(torch.as_tensor(b)).numpy()
    h, y = _received(rng, x if domain == "freq" else x[..., None, :],
                     num_rx_ant, no)
    if domain == "time":
        y = y[..., 0, :]
    seen = {}
    hooks = [_capture(trx._mimo_detector, seen, "det")]
    h_full = np.broadcast_to(h, h.shape[:5] + (
        ttx.resource_grid.num_ofdm_symbols,
        ttx.resource_grid.fft_size)).copy()
    args = (torch.as_tensor(y), torch.tensor(no))
    if csi == "perfect":
        args += (torch.as_tensor(h_full),)
    b_hat, crc = trx(*args)
    for hook in hooks:
        hook.remove()
    (y_det, h_hat, _, _), llr_det = seen["det"]

    y_j = jnp.asarray(y)
    if domain == "time":
        y_j = jax.jit(jrx._ofdm_demodulator)(y_j)
        assert _rel_err(y_det, y_j) <= DEMOD_RTOL
    else:
        np.testing.assert_array_equal(y_det, y)
    jh_hat, jllr, jb_hat, jcrc = _jax_stages(jrx, y_j, jnp.float32(no),
                                             h_full, csi == "perfect")
    assert _rel_err(h_hat, jh_hat) <= EST_RTOL
    llr = trx._layer_demapper(llr_det).numpy()
    assert _rel_err(llr, jllr) <= LLR_RTOL
    np.testing.assert_array_equal(b_hat.numpy(), np.asarray(jb_hat))
    np.testing.assert_array_equal(crc.numpy(), np.asarray(jcrc))
    np.testing.assert_array_equal(b_hat.numpy(), b)
    assert bool(crc.all())


def test_receiver_errors():
    tx = tnr.PUSCHTransmitter(tutorial_config(tnr, 1))
    with pytest.raises(ValueError, match="l_min"):
        tnr.PUSCHReceiver(tx, input_domain="time")
    with pytest.raises(ValueError):
        tnr.PUSCHReceiver(tx, input_domain="sample")
    rx = tnr.PUSCHReceiver(tx, channel_estimator="perfect")
    with pytest.raises(ValueError, match="perfect CSI"):
        rx(torch.zeros(1, 1, 2, 14, 12, dtype=torch.complex64),
           torch.tensor(0.1))
