"""The 5G NR configuration tree, DMRS grids, layer mapping and transport
block coding of the PyTorch port against the JAX package and the stored
references under ``tests/nr/``.

The NR blocks carry no trainable weights: both packages' configurations
are built from the same settings by ``load_pusch_config``, which takes
either package's ``PUSCHConfig`` class.

Tolerances:
- the configuration tree: every derived property equal (the arrays
  bit-exact: both packages run the same NumPy arithmetic);
- the DMRS grids against the stored references: DMRS_ATOL, as in
  ``tests/test_nr_goldens.py``;
- layer mapping and the TB encoder: bit-exact;
- the TB decoder on noisy LLRs: hard decisions and CRC flags identical
  to JAX's (the soft values of boxplus-phi drift from XLA's f32
  tanh/log1p by a few ULP per check-node update, which moves no
  decision of these cases).
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.nr as jnr
import sionna_tpu_torch.phy.nr as tnr
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

NR_DIR = os.path.join(os.path.dirname(__file__), "nr")
CFG_DIR = os.path.join(NR_DIR, "pusch_test_configs")
# the 12 golden configurations of tests/test_nr.py
GOLDEN_IDS = [0, 5, 11, 19, 27, 35, 43, 51, 59, 67, 75, 82]
DMRS_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def load_pusch_config(pusch_config_cls, cfg):
    """A ``PUSCHConfig`` of either package from a golden configuration
    (the settings of ``tests/test_nr.py:load_pusch_config``)."""
    pc = pusch_config_cls()
    pc.carrier.n_cell_id = cfg["carrier"]["n_cell_id"]
    pc.carrier.slot_number = cfg["carrier"]["slot_number"]
    pc.n_size_bwp = cfg["pusch"]["n_size_bwp"]
    pc.symbol_allocation = cfg["pusch"]["symbol_allocation"]
    pc.n_rnti = cfg["pusch"]["n_rnti"]
    pc.num_antenna_ports = cfg["pusch"]["num_antenna_ports"]
    pc.num_layers = cfg["pusch"]["num_layers"]
    pc.precoding = cfg["pusch"]["precoding"]
    if pc.precoding == "codebook":
        pc.tpmi = cfg["pusch"]["tpmi"]
    d = cfg["pusch"]["dmrs"]
    pc.dmrs.length = d["length"]
    pc.dmrs.config_type = d["config_type"]
    pc.dmrs.additional_position = d["additional_position"]
    pc.dmrs.num_cdm_groups_without_data = d["num_cdm_groups_without_data"]
    pc.dmrs.dmrs_port_set = d["dmrs_port_set"]
    pc.dmrs.n_scid = d["n_scid"]
    pc.dmrs.n_id = d["n_id"]
    pc.tb.mcs_index = cfg["pusch"]["tb"]["mcs_index"]
    pc.tb.mcs_table = cfg["pusch"]["tb"]["mcs_table"]
    return pc


def golden_config(test_id):
    with open(os.path.join(CFG_DIR, f"test_{test_id}.json")) as f:
        return json.load(f)


def golden_waveform(test_id):
    """(bits, grid) of a stored waveform. Its bits are pickled as a
    TensorFlow tensor: they read back as a NumPy array, without
    importing TensorFlow."""
    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == ("tensorflow.python.framework.ops",
                                  "convert_to_tensor"):
                return lambda value, *args, **kwargs: np.asarray(value)
            return super().find_class(module, name)

    with open(os.path.join(CFG_DIR, f"test_{test_id}.npy"), "rb") as f:
        if np.lib.format.read_magic(f) == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        b, grid = Unpickler(f).load()
    return np.asarray(b), np.asarray(grid)


def _public_values(cfg):
    """Every public non-callable attribute of a config object, the
    sub-configurations left out."""
    out = {}
    for a in dir(cfg):
        if a.startswith("_") or a in ("carrier", "dmrs", "tb"):
            continue
        v = getattr(cfg, a)
        if not callable(v):
            out[a] = v
    return out


def _assert_same(got, want, what):
    if want is None or isinstance(want, (str, bool)):
        assert got == want, what
    elif isinstance(want, (list, tuple)) and want and not np.isscalar(
            want[0]) and want[0] is not None:
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("test_id", GOLDEN_IDS)
def test_config_tree_matches_jax(test_id):
    """Every derived property of the PUSCH, carrier, DMRS and TB
    configurations, and c_init of every symbol, equal to JAX's."""
    cfg = golden_config(test_id)
    tpc = load_pusch_config(tnr.PUSCHConfig, cfg)
    jpc = load_pusch_config(jnr.PUSCHConfig, cfg)
    assert tpc.check_config() and jpc.check_config()
    for sub in (None, "carrier", "dmrs", "tb"):
        t = tpc if sub is None else getattr(tpc, sub)
        j = jpc if sub is None else getattr(jpc, sub)
        want = _public_values(j)
        got = _public_values(t)
        assert sorted(got) == sorted(want), sub
        for name, w in want.items():
            _assert_same(got[name], w, f"{sub}.{name}")
    for sym in range(tpc.carrier.num_symbols_per_slot):
        assert tpc.c_init(sym) == jpc.c_init(sym)
    # the arrays stay float64/complex128 NumPy, as in JAX
    assert tpc.dmrs_grid.dtype == np.complex128
    assert tpc.dmrs_mask.dtype == bool


def test_config_errors_match_jax():
    """The same settings are refused by both packages."""
    bad = [("num_layers", 2), ("precoding", "codebook"),
           ("symbol_allocation", [1, 14])]
    for name, value in bad:
        for mod in (tnr, jnr):
            pc = mod.PUSCHConfig()
            setattr(pc, name, value)
            with pytest.raises(ValueError):
                pc.check_config()
    for mod in (tnr, jnr):
        with pytest.raises(ValueError):
            mod.CarrierConfig(n_size_grid=276)
        with pytest.raises(ValueError):
            mod.TBConfig(mcs_index=29)
        with pytest.raises(ValueError):
            mod.PUSCHDMRSConfig(config_type=3)
        with pytest.raises(TypeError):
            mod.check_pusch_configs(mod.PUSCHConfig())


def test_check_pusch_configs_matches_jax():
    """check_pusch_configs of one and of two UEs (ports [0, 1] and
    [2, 3], codebook precoding): every parameter equal."""
    def two_ues(mod):
        pcs = []
        for ports, rnti in (([0, 1], 11), ([2, 3], 22)):
            pc = mod.PUSCHConfig()
            pc.carrier.subcarrier_spacing = 30
            pc.carrier.n_size_grid = 3
            pc.num_antenna_ports = 4
            pc.num_layers = 2
            pc.precoding = "codebook"
            pc.tpmi = 3
            pc.dmrs.dmrs_port_set = ports
            pc.n_rnti = rnti
            pcs.append(pc)
        return pcs

    cases = [lambda mod: [load_pusch_config(mod.PUSCHConfig,
                                            golden_config(19))], two_ues]
    for make in cases:
        got = tnr.check_pusch_configs(make(tnr))
        want = jnr.check_pusch_configs(make(jnr))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if key in ("pusch_config", "carrier_config"):
                continue
            _assert_same(got[key], w, key)


def _dmrs_pilot_sweep(pusch_config_cls, n_size_grid):
    """The reference's pilot-collection loop (as in
    tests/test_nr_goldens.py): config-type-2 double-symbol DMRS, swept
    over cell id / slot / port."""
    pc = pusch_config_cls()
    pc.carrier.n_size_grid = n_size_grid
    pc.dmrs.config_type = 2
    pc.dmrs.num_cdm_groups_without_data = 3
    pc.dmrs.additional_position = 1
    pc.dmrs.length = 2
    pc.dmrs.n_id = [4, 4]
    p = []
    for n_cell_id in [0, 1, 10, 24, 99, 1006]:
        for slot_number in [0, 1, 5, 9]:
            for port_set in [0, 3, 4, 9, 11]:
                pc.carrier.n_cell_id = n_cell_id
                pc.carrier.slot_number = slot_number
                pc.dmrs.dmrs_port_set = [port_set]
                a = np.asarray(pc.dmrs_grid)
                pilots = np.concatenate(
                    [a[0, :, 2], a[0, :, 3], a[0, :, 10], a[0, :, 11]])
                pilots = pilots[np.where(pilots)] / np.sqrt(3)
                p.append(pilots)
    return np.transpose(np.array(p))


@pytest.mark.parametrize("n_size_grid,fname", [
    (1, "reference_dmrs_1.npy"), (4, "reference_dmrs_2.npy")])
def test_dmrs_grid_against_reference(n_size_grid, fname):
    ref = np.load(os.path.join(NR_DIR, fname))
    got = _dmrs_pilot_sweep(tnr.PUSCHConfig, n_size_grid)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=DMRS_ATOL)


@pytest.mark.parametrize("num_layers,num_ports,num_tpmi",
                         [(1, 2, 6), (1, 4, 28), (2, 2, 3), (2, 4, 22),
                          (3, 4, 7), (4, 4, 5)])
def test_dmrs_precoded_against_reference(num_layers, num_ports, num_tpmi):
    """Codebook-precoded DMRS grids for every TPMI against the stored
    references, and the precoding matrices equal to JAX's."""
    ref = np.load(os.path.join(
        NR_DIR, f"pusch_dmrs_precoded_{num_layers}_layer_"
                f"{num_ports}_ports.npy"), allow_pickle=True)
    pcs = []
    for mod in (tnr, jnr):
        pc = mod.PUSCHConfig()
        pc.carrier.n_size_grid = 1
        pc.carrier.slot_number = 1
        pc.dmrs.additional_position = 0
        pc.dmrs.config_type = 2
        pc.dmrs.num_cdm_groups_without_data = 3
        pc.dmrs.length = 2
        pc.dmrs.n_id = [8, 8]
        pc.precoding = "codebook"
        pc.num_layers = num_layers
        pc.num_antenna_ports = num_ports
        pcs.append(pc)
    tpc, jpc = pcs
    for i in range(num_tpmi):
        tpc.tpmi = jpc.tpmi = i
        got = np.asarray(tpc.dmrs_grid_precoded) / np.sqrt(3)
        np.testing.assert_allclose(got, ref[i], atol=DMRS_ATOL,
                                   err_msg=f"tpmi={i}")
        np.testing.assert_array_equal(tpc.precoding_matrix,
                                      jpc.precoding_matrix)


@pytest.mark.parametrize("num_layers", [1, 2, 3, 4, 5, 6, 7, 8])
def test_layer_mapping_matches_jax(num_layers):
    """LayerMapper (one codeword up to 4 layers, two from 5) and
    LayerDemapper bit-exact against JAX, and the round trip."""
    rng = np.random.default_rng(num_layers)
    nbps = 4
    tm, jm = tnr.LayerMapper(num_layers), jnr.LayerMapper(num_layers)
    assert (tm.num_codewords, tm.num_layers0, tm.num_layers1) == \
        (jm.num_codewords, jm.num_layers0, jm.num_layers1)
    if tm.num_codewords == 1:
        x = (rng.normal(size=(3, 2, 12 * num_layers))
             + 1j * rng.normal(size=(3, 2, 12 * num_layers))).astype(
            np.complex64)
        got = tm(torch.as_tensor(x)).numpy()
        want = np.asarray(jm(jnp.asarray(x)))
    else:
        x = [(rng.normal(size=(3, 12 * n)) + 1j * rng.normal(
            size=(3, 12 * n))).astype(np.complex64)
            for n in (tm.num_layers0, tm.num_layers1)]
        got = tm([torch.as_tensor(v) for v in x]).numpy()
        want = np.asarray(jm([jnp.asarray(v) for v in x]))
    assert got.shape == want.shape and got.shape[-2] == num_layers
    np.testing.assert_array_equal(got, want)

    td = tnr.LayerDemapper(tm, num_bits_per_symbol=nbps)
    jd = jnr.LayerDemapper(jm, num_bits_per_symbol=nbps)
    llr = rng.normal(size=got.shape[:-1] + (got.shape[-1] * nbps,)).astype(
        np.float32)
    got_d, want_d = td(torch.as_tensor(llr)), jd(jnp.asarray(llr))
    if tm.num_codewords == 1:
        got_d, want_d = [got_d], [want_d]
    for g, w in zip(got_d, want_d):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if tm.num_codewords == 1:
        # the round trip: the bits of each symbol, mapped to layers as
        # their symbols are, come back in their order
        num_sym = got.shape[-1] * num_layers
        bits = np.arange(num_sym * nbps, dtype=np.float32).reshape(
            num_sym, nbps)
        sym = tm(torch.arange(num_sym, dtype=torch.float32)).long()
        back = td(torch.as_tensor(bits[sym.numpy()].reshape(num_layers,
                                                            -1)))
        np.testing.assert_array_equal(back.numpy(), bits.reshape(-1))


TB_CASES = sorted(glob.glob(os.path.join(NR_DIR, "tb_refs",
                                         "tb_testcase_*.npz")))


def _tb_encoder(mod, data, **kw):
    return mod.TBEncoder(
        num_coded_bits=data["c_ref"].shape[1],
        target_tb_size=data["u_ref"].shape[1],
        target_coderate=float(data["coderate"]),
        num_bits_per_symbol=int(data["num_bits_per_symbol"]),
        num_layers=int(data["num_layers"]), n_rnti=int(data["n_rnti"]),
        n_id=int(data["n_id"]), **kw)


@pytest.mark.parametrize("path", TB_CASES,
                         ids=[os.path.basename(p) for p in TB_CASES])
def test_tb_encoder_against_reference(path):
    """Bit-exact TB encoding (segmentation, CRCs, LDPC, rate matching,
    interleaving, scrambling) against the stored references, with and
    without the scrambler, and the clean round trip through TBDecoder."""
    data = np.load(path)
    u_ref = data["u_ref"].astype(np.float32)
    enc = _tb_encoder(tnr, data, channel_type="PUSCH", codeword_index=0)
    c = enc(torch.as_tensor(u_ref))
    assert c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy().astype(np.uint8),
                                  data["c_ref"])
    c_ns = _tb_encoder(tnr, data, use_scrambler=False)(
        torch.as_tensor(u_ref))
    np.testing.assert_array_equal(c_ns.numpy().astype(np.int8),
                                  data["c_ref_no_scr"])
    u_hat, crc_ok = tnr.TBDecoder(enc, cn_update="minsum")(2.0 * c - 1.0)
    np.testing.assert_array_equal(u_hat.numpy(), u_ref)
    assert bool(crc_ok.all())


def _tb_pair(num_tx=1, target_tb_size=3976):
    """Both packages' TBEncoder of a TB of two code blocks of different
    rate-matched lengths (10,000 and 10,002 bits; QPSK, rate 0.2), for
    ``num_tx`` transmitters."""
    kw = dict(target_tb_size=target_tb_size, num_coded_bits=20002,
              target_coderate=0.2, num_bits_per_symbol=2)
    if num_tx > 1:
        kw.update(n_rnti=[7, 1000][:num_tx], n_id=[3, 500][:num_tx])
    return tnr.TBEncoder(**kw), jnr.TBEncoder(**kw)


@pytest.mark.parametrize("num_tx,target_tb_size", [(1, 3976), (2, 3960)])
def test_tb_encoder_matches_jax(num_tx, target_tb_size):
    """A multi-CB TB with code blocks of different lengths (and two
    transmitters' scrambling sequences, and zero padding up to the TB
    size): the segmentation and the output permutation equal to JAX's,
    the codewords bit-exact."""
    tenc, jenc = _tb_pair(num_tx, target_tb_size)
    assert tenc.num_cbs > 1 and len(set(tenc.cw_lengths)) == 2
    assert tenc.k_padding == 3976 - target_tb_size
    for name in ("tb_size", "k", "k_padding", "n", "num_cbs", "cb_size",
                 "coderate", "num_tx", "tb_crc_length"):
        assert getattr(tenc, name) == getattr(jenc, name), name
    np.testing.assert_array_equal(tenc.cw_lengths, jenc.cw_lengths)
    np.testing.assert_array_equal(tenc.output_perm_inv,
                                  jenc.output_perm_inv)
    b = np.random.default_rng(num_tx).integers(
        0, 2, (3, num_tx, tenc.k)).astype(np.float32)
    got = tenc(torch.as_tensor(b)).numpy()
    want = np.asarray(jax.jit(jenc)(jnp.asarray(b)))
    assert got.shape == (3, num_tx, tenc.n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cn_update,num_bp_iter,sigma",
                         [("boxplus-phi", 20, 1.55), ("minsum", 12, 1.3)])
def test_tb_decoder_matches_jax(cn_update, num_bp_iter, sigma):
    """TBDecoder on JAX-drawn noisy channel LLRs of a multi-CB TB, at
    two noise levels (all TBs decoded, and some lost): hard decisions
    and TB CRC flags identical to JAX's."""
    tenc, jenc = _tb_pair()
    tdec = tnr.TBDecoder(tenc, num_bp_iter=num_bp_iter,
                         cn_update=cn_update)
    jdec = jnr.TBDecoder(jenc, num_bp_iter=num_bp_iter,
                         cn_update=cn_update)
    b = np.random.default_rng(5).integers(
        0, 2, (6, 1, tenc.k)).astype(np.float32)
    c = np.asarray(jax.jit(jenc)(jnp.asarray(b)))
    ok = []
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), c.shape,
                                         jnp.float32))
    for s in (1.0, sigma):
        llr = (2 * (2 * c - 1) + 2 * s * noise) / s ** 2
        llr = llr.astype(np.float32)
        u_hat, crc = tdec(torch.as_tensor(llr))
        ju_hat, jcrc = jax.jit(jdec)(jnp.asarray(llr))
        assert u_hat.shape == (6, 1, tenc.k) and crc.shape == (6, 1)
        assert crc.dtype == torch.bool
        np.testing.assert_array_equal(u_hat.numpy(), np.asarray(ju_hat))
        np.testing.assert_array_equal(crc.numpy(), np.asarray(jcrc))
        np.testing.assert_array_equal(
            crc.numpy(), np.all(u_hat.numpy() == b, axis=-1))
        ok.append(int(crc.sum()))
    assert ok[0] == 6 and ok[1] < 6  # both regimes reached


def test_tb_decoder_kernel_or_raise():
    """A TBDecoder's LDPC decoder takes the lifted engine (K1 on the
    card, the plain lifted decode on the CPU), for both CN rules."""
    tenc, _ = _tb_pair()
    for cn in ("boxplus-phi", "minsum"):
        dec = tnr.TBDecoder(tenc, cn_update=cn)
        assert dec._decoder.lifted is not None
    with pytest.raises(TypeError):
        tnr.TBDecoder(object())
