"""CRC and scrambling of the PyTorch port against the JAX package: the CRC
encoder and decoder bit-exact against the goldens in ``tests/codes/crc``
and against JAX, the Gold sequence and ``TB5GScrambler`` bit-exact, and
``Scrambler`` (whose random draws come from a ``torch.Generator``, which
JAX's ``jax.random`` streams cannot match) by involution, an explicit
``sequence=`` and statistics."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.fec.crc as jcrc
import sionna_tpu.phy.fec.scrambling as jscr
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec import (CRCDecoder, CRCEncoder, Descrambler,
                                      Scrambler, TB5GScrambler)
from sionna_tpu_torch.phy.fec.scrambling import generate_prng_seq
from sionna_tpu_torch.phy.utils import load_numpy_state

torch.set_num_threads(2)

CODES = Path(__file__).resolve().parent / "codes" / "crc"
DEGREES = ["CRC6", "CRC11", "CRC16", "CRC24A", "CRC24B", "CRC24C"]


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _bits(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(
        np.float32)


@pytest.mark.parametrize("deg", DEGREES)
def test_crc_encoder_matches_golden_and_jax(deg):
    u = np.load(CODES / f"crc_u_{deg}.npy")
    x_ref = np.load(CODES / f"crc_x_ref_np_{deg}.npy")
    enc = CRCEncoder(deg)
    x = enc(torch.as_tensor(u, dtype=torch.float32)).numpy().reshape(-1)
    np.testing.assert_array_equal(x[-enc.crc_length:], x_ref)
    # random words of several lengths, leading dimensions kept
    jenc = jcrc.CRCEncoder(deg)
    for k in (1, 40, 333):
        b = _bits((2, 3, k), seed=k)
        got = enc(torch.as_tensor(b))
        assert got.shape == (2, 3, k + enc.crc_length)
        assert (enc.k, enc.n) == (k, k + enc.crc_length)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jenc(jnp.asarray(b))))
    # the parity matrix, exported from JAX, checks equal; a change fails
    load_numpy_state(enc, {"parity_matrix": jenc._get_pmat(333)})
    bad = jenc._get_pmat(333).copy()
    bad[0, 0] = 1 - bad[0, 0]
    with pytest.raises(ValueError, match="parity_matrix"):
        load_numpy_state(enc, {"parity_matrix": bad})


def test_crc_decoder_matches_jax():
    """Valid words pass, words with one flipped bit fail, in both
    packages alike; the info bits come back."""
    enc, jenc = CRCEncoder("CRC24A"), jcrc.CRCEncoder("CRC24A")
    dec, jdec = CRCDecoder(enc), jcrc.CRCDecoder(jenc)
    assert dec.encoder is enc
    b = _bits((4, 3, 100), seed=1)
    x = enc(torch.as_tensor(b)).numpy()
    flips = np.random.default_rng(2).random(x.shape) < 0.005
    x[flips] = 1 - x[flips]
    u, valid = dec(torch.as_tensor(x))
    ju, jvalid = jdec(jnp.asarray(x))
    assert valid.dtype == torch.bool and valid.shape == (4, 3, 1)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(valid.numpy()[..., 0],
                                  ~flips.any(axis=-1))
    with pytest.raises(TypeError):
        CRCDecoder(object())
    with pytest.raises(ValueError):
        CRCEncoder("CRC7")


@pytest.mark.parametrize("length,c_init", [(1, 0), (100, 1), (333, 2**15 + 7),
                                           (4000, 2**31 - 1)])
def test_generate_prng_seq_matches_jax(length, c_init):
    got = generate_prng_seq(length, c_init)
    assert got.dtype == np.float32 and got.shape == (length,)
    np.testing.assert_array_equal(got, jscr.generate_prng_seq(length, c_init))


@pytest.mark.parametrize("kwargs", [
    {},
    {"n_rnti": 1234, "n_id": 567, "channel_type": "PDSCH",
     "codeword_index": 1},
    {"n_rnti": [1, 2, 3], "n_id": [4, 5, 6]},
])
def test_tb5g_scrambler_matches_jax(kwargs):
    """Bits and LLRs, single and multi-stream, and the descrambler."""
    shape = (2, 3, 150)
    b = _bits(shape, seed=3)
    llr = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ts, js = TB5GScrambler(**kwargs), jscr.TB5GScrambler(**kwargs)
    tb = ts(torch.as_tensor(b))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(js(jnp.asarray(b))))
    np.testing.assert_array_equal(
        ts(torch.as_tensor(llr), binary=False).numpy(),
        np.asarray(js(jnp.asarray(llr), binary=False)))
    td = Descrambler(ts)
    np.testing.assert_array_equal(td(tb).numpy(), b)
    tl = TB5GScrambler(binary=False, **kwargs)
    np.testing.assert_array_equal(
        Descrambler(tl, binary=False)(tl(torch.as_tensor(llr))).numpy(), llr)
    if "n_rnti" in kwargs and isinstance(kwargs["n_rnti"], list):
        with pytest.raises(ValueError):
            ts(torch.zeros(2, 4, 10))


def test_tb5g_scrambler_rejects_bad_arguments():
    for kwargs, err in (({"n_rnti": 2**16}, ValueError),
                        ({"n_id": 1024}, ValueError),
                        ({"channel_type": "PBCH"}, TypeError),
                        ({"codeword_index": 2}, ValueError),
                        ({"n_rnti": [1, 2], "n_id": [1]}, ValueError),
                        ({"binary": 1}, TypeError)):
        with pytest.raises(err):
            TB5GScrambler(**kwargs)


def test_scrambler_involution_sequence_and_statistics():
    """The port's Scrambler: an involution for a fixed seed (bits and
    LLRs), JAX's output for an explicit ``sequence=``, about half the
    bits flipped, one sequence per batch with ``keep_batch_constant``,
    a new sequence per call with ``keep_state=False``."""
    b = _bits((64, 500), seed=5)
    tb = torch.as_tensor(b)
    s = Scrambler(seed=123)
    assert s.seed == 123 and s.keep_state
    x = s(tb)
    assert not torch.equal(x, tb)
    np.testing.assert_array_equal(s(x).numpy(), b)
    np.testing.assert_array_equal(Descrambler(s)(x).numpy(), b)
    llr = torch.randn(64, 500, generator=torch.Generator().manual_seed(0))
    sl = Scrambler(seed=123, binary=False)
    np.testing.assert_array_equal(sl(sl(llr)).numpy(), llr.numpy())
    # the flips of the LLR and bit forms are the same sequence
    np.testing.assert_array_equal((sl(llr) != llr).numpy(),
                                  (x != tb).numpy())
    # statistics: flip rate 1/2 within 5 standard errors
    rate = float((x != tb).float().mean())
    assert abs(rate - 0.5) < 5 * (0.25 / x.numel()) ** 0.5
    # a call-time seed; the same seed again descrambles
    y = s(tb, seed=77)
    assert not torch.equal(y, x)
    np.testing.assert_array_equal(Descrambler(s)(y, seed=77).numpy(), b)
    # keep_batch_constant: one sequence for the whole batch
    sc = Scrambler(seed=9, keep_batch_constant=True)
    flips = (sc(tb) != tb).numpy()
    assert (flips == flips[:1]).all() and flips.any()
    # keep_state=False: each call a new sequence
    sn = Scrambler(seed=9, keep_state=False)
    assert not torch.equal(sn(tb), sn(tb))
    with pytest.raises(ValueError):
        Descrambler(sn)
    # an explicit sequence: JAX's output, bit for bit
    seq = _bits((500,), seed=6)
    for binary, v in ((True, b), (False, llr.numpy())):
        ts = Scrambler(sequence=seq, binary=binary)
        js = jscr.Scrambler(sequence=seq, binary=binary)
        np.testing.assert_array_equal(ts(torch.as_tensor(v)).numpy(),
                                      np.asarray(js(jnp.asarray(v))))
    np.testing.assert_array_equal(Scrambler(sequence=seq).sequence, seq)
    with pytest.raises(TypeError):
        Scrambler(seed=1.5)
    with pytest.raises(TypeError):
        Descrambler(object())


def test_scrambler_seed_from_config():
    """``seed=None`` draws the seed from ``config.np_rng``, in both
    packages from a NumPy generator seeded alike."""
    from sionna_tpu.phy import config as jax_config
    old_seed = torch_config.seed
    torch_config.seed = 21
    jax_config.seed = 21
    try:
        assert Scrambler().seed == jscr.Scrambler().seed
    finally:
        torch_config.seed = old_seed
