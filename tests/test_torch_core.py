"""Core of the PyTorch port against the JAX package: precision and dtypes,
the Block casting contract, ebnodb2no, hard decisions and the error
metrics, the tensor utilities, the rule that the port never imports JAX,
and that it has every public name of the JAX package's subpackages."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.utils as jutils
import sionna_tpu_torch.phy.utils as tutils
from sionna_tpu_torch.phy import Block, config, dtypes
from sionna_tpu_torch.phy.utils import expand_to_rank
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

REPO = Path(__file__).resolve().parent.parent


class _Echo(Block):
    """Returns its (cast) inputs."""

    def forward(self, *args, **kwargs):
        return args, kwargs


@pytest.fixture
def port_config():
    """The port's global config, restored after the test."""
    seed, precision, device = config.seed, config.precision, config.device
    yield config
    config.seed, config.precision = seed, precision
    config.device = device


def test_precision_dtypes(port_config):
    assert dtypes["single"]["torch"] == {"rdtype": torch.float32,
                                         "cdtype": torch.complex64}
    assert dtypes["double"]["torch"] == {"rdtype": torch.float64,
                                         "cdtype": torch.complex128}
    assert (port_config.rdtype, port_config.cdtype) == (torch.float32,
                                                        torch.complex64)
    port_config.precision = "double"
    assert (port_config.rdtype, port_config.cdtype) == (torch.float64,
                                                        torch.complex128)
    assert _Echo().rdtype == torch.float64
    assert _Echo(precision="single").cdtype == torch.complex64
    with pytest.raises(ValueError):
        port_config.precision = "half"
    with pytest.raises(ValueError):
        _Echo(precision="half")


@pytest.mark.parametrize("precision", ["single", "double"])
def test_block_casting_contract(precision):
    blk = _Echo(precision=precision)
    rdt, cdt = dtypes[precision]["torch"].values()
    ints = torch.arange(4)
    (f, c, i, b, a, s, nested), kw = blk(
        torch.ones(3, dtype=torch.float64), torch.ones(3, dtype=torch.complex128),
        ints, torch.ones(2, dtype=torch.bool), np.ones(2, np.float64), 0.5,
        [torch.ones(1, dtype=torch.float16), 7], z=np.ones(2, np.complex64))
    assert f.dtype == rdt and c.dtype == cdt and a.dtype == rdt
    assert i is ints and b.dtype == torch.bool
    assert isinstance(s, torch.Tensor) and s.dtype == rdt and float(s) == 0.5
    assert nested[0].dtype == rdt and nested[1] == 7
    assert kw["z"].dtype == cdt


def test_block_buffers_follow_to():
    blk = _Echo()
    assert blk.device == torch.device("cpu")
    assert blk.to("cpu") is blk and blk.device.type == "cpu"
    assert dict(blk.named_parameters()) == {}


def test_config_device_defaults_to_the_card():
    """Without ``device`` a block lands on ``config.device``, "cuda" by
    default. Where there is no card that default does not fall back to
    the CPU: making the block raises torch's own error."""
    code = (
        "import torch\n"
        "from sionna_tpu_torch.phy import BinarySource, config\n"
        "print(config.device)\n"
        "try:\n"
        "    print(BinarySource()([4]).device.type)\n"
        "except (AssertionError, RuntimeError) as err:\n"
        "    print('raised', type(err).__name__, err)\n"
        "print(torch.cuda.is_available())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    device, made, has_card = proc.stdout.strip().splitlines()
    assert device == "cuda"
    if has_card == "True":
        assert made == "cuda"
    else:
        assert made.startswith("raised") and "CUDA" in made


def test_blocks_take_config_device(port_config):
    """A block, the LDPC code's tables, the TDL model's draws and the
    default generator follow ``config.device`` when no ``device`` is
    given, and an explicit ``device`` wins."""
    from sionna_tpu_torch.phy import BinarySource
    from sionna_tpu_torch.phy.channel.tr38901 import TDL
    from sionna_tpu_torch.phy.fec.ldpc import (LDPC5GDecoder,
                                               LDPC5GEncoder,
                                               WeightedBPCallback)
    port_config.device = "meta"
    assert _Echo().device == torch.device("meta")
    assert _Echo(device="cpu").device == torch.device("cpu")
    assert WeightedBPCallback(5).weights.device.type == "meta"
    port_config.device = "cpu"
    assert port_config.device == torch.device("cpu")
    assert port_config.generator().device == torch.device("cpu")
    assert BinarySource()([8]).device.type == "cpu"
    dec = LDPC5GDecoder(LDPC5GEncoder(100, 200))
    assert {b.device.type for b in dec.buffers()} == {"cpu"}
    assert {b.device.type for b in dec.lifted.buffers()} == {"cpu"}
    a, tau = TDL("A", 100e-9, 3.5e9)(2, 3, 1e6)
    assert a.device.type == tau.device.type == "cpu"
    # the blocks that draw or make tensors from nothing
    from sionna_tpu_torch.phy.channel import (CIRDataset, FlatFadingChannel,
                                              GenerateFlatFadingChannel,
                                              KroneckerModel,
                                              RayleighBlockFading)
    from sionna_tpu_torch.phy.channel.optical import EDFA, SSFM
    from sionna_tpu_torch.phy.signal import RootRaisedCosineFilter
    assert GenerateFlatFadingChannel(2, 4)(3).device.type == "cpu"
    y, h = FlatFadingChannel(2, 4, return_channel=True)(
        torch.ones(3, 2, dtype=torch.complex64), 0.1)
    assert y.device.type == h.device.type == "cpu"
    a, tau = RayleighBlockFading(1, 2, 1, 2)(2, 3)
    assert a.device.type == tau.device.type == "cpu"
    a, tau = CIRDataset(lambda: iter([(np.ones((1, 1, 1, 1, 1, 1)),
                                       np.zeros((1, 1, 1)))]),
                        2, 1, 1, 1, 1, 1, 1)()
    assert a.device.type == tau.device.type == "cpu"
    x = torch.ones(2, 16, dtype=torch.complex64)
    assert EDFA()(x).device.type == "cpu"
    assert SSFM(with_amplification=True, n_ssfm=2)(x).device.type == "cpu"
    port_config.device = "meta"
    assert RootRaisedCosineFilter(4, 4, 0.2).coefficients.device.type \
        == "meta"
    assert KroneckerModel(None, np.eye(2))._r_rx_sqrt.device.type == "meta"
    assert CIRDataset(None, 1, 1, 1, 1, 1, 1, 1)._device.type == "meta"
    assert RayleighBlockFading(1, 1, 1, 1)._device.type == "meta"


def _blocks_without_device():
    """{name: constructor} of blocks with tables, built with no
    ``device``."""
    from sionna_tpu_torch.phy import AWGN, BinarySource, Demapper, Mapper
    from sionna_tpu_torch.phy.fec.interleaving import RowColumnInterleaver
    from sionna_tpu_torch.phy.fec.ldpc import (LDPC5GEncoder,
                                               LDPCBPDecoder)
    from sionna_tpu_torch.phy.fec.linear import LinearEncoder, OSDecoder
    from sionna_tpu_torch.phy.fec.utils import load_parity_check_examples
    from sionna_tpu_torch.phy.ofdm import ResourceGrid, ResourceGridMapper
    from sionna_tpu_torch.phy.channel import FlatFadingChannel
    from sionna_tpu_torch.phy.signal import (CustomWindow,
                                             RootRaisedCosineFilter)
    pcm = load_parity_check_examples(0)[0]
    return {
        "RootRaisedCosineFilter": lambda: RootRaisedCosineFilter(
            4, 4, 0.2, window="hann"),
        "CustomWindow": lambda: CustomWindow(np.ones(8)),
        "FlatFadingChannel": lambda: FlatFadingChannel(2, 4),
        "LinearEncoder": lambda: LinearEncoder(pcm, is_pcm=True),
        "OSDecoder": lambda: OSDecoder(pcm, t=1, is_pcm=True),
        "Mapper": lambda: Mapper("qam", 4),
        "Demapper": lambda: Demapper("app", "qam", 4),
        "AWGN": AWGN,
        "BinarySource": BinarySource,
        "RowColumnInterleaver": lambda: RowColumnInterleaver(4),
        "LDPC5GEncoder": lambda: LDPC5GEncoder(100, 200),
        "LDPCBPDecoder": lambda: LDPCBPDecoder(pcm),
        "ResourceGridMapper": lambda: ResourceGridMapper(ResourceGrid(
            num_ofdm_symbols=14, fft_size=64, subcarrier_spacing=30e3,
            pilot_pattern="kronecker", pilot_ofdm_symbol_indices=[2, 11])),
    }


@pytest.mark.parametrize("name", ["LinearEncoder", "OSDecoder", "Mapper",
                                  "Demapper", "AWGN", "BinarySource",
                                  "RowColumnInterleaver", "LDPC5GEncoder",
                                  "LDPCBPDecoder", "ResourceGridMapper",
                                  "RootRaisedCosineFilter", "CustomWindow",
                                  "FlatFadingChannel"])
def test_block_tables_take_config_device(port_config, name):
    """Every buffer and parameter of a block built with no ``device``
    lies on ``config.device``, not only its reported device."""
    port_config.device = "meta"
    blk = _blocks_without_device()[name]()
    assert blk.device == torch.device("meta")
    assert {t.device.type for t in (*blk.buffers(), *blk.parameters())} \
        == {"meta"}


def test_seed_reproduces_streams(port_config):
    from sionna_tpu_torch.phy import BinarySource
    port_config.seed = 3
    a = BinarySource()([64])
    n1 = port_config.np_rng.normal()
    port_config.seed = 3
    assert torch.equal(BinarySource()([64]), a)
    assert port_config.np_rng.normal() == n1
    g = torch.Generator().manual_seed(5)
    b = BinarySource()([64], generator=g)
    assert torch.equal(
        BinarySource()([64], generator=torch.Generator().manual_seed(5)), b)


def test_expand_to_rank_matches_jax():
    x = np.arange(6.).reshape(2, 3)
    for rank, axis in [(4, -1), (4, 0), (3, 1), (2, 0)]:
        want = np.asarray(jutils.expand_to_rank(jnp.asarray(x), rank, axis))
        got = expand_to_rank(torch.as_tensor(x), rank, axis).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ebnodb2no_matches_jax():
    # f32 pow/div: XLA:CPU and torch may round the last place
    # differently; 2 ULP of f32 relative.
    for ebno_db in (-2.0, 0.0, 3.0, 4.5, 10.0):
        for nbps, r in ((1, 1.0), (2, 0.5), (4, 1024 / 2048), (6, 0.33)):
            want = np.asarray(jutils.ebnodb2no(jnp.float32(ebno_db), nbps, r),
                              np.float32)
            got = tutils.ebnodb2no(ebno_db, nbps, r)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7)
    got = tutils.ebnodb2no(torch.tensor([1., 2.], dtype=torch.float64), 2,
                           0.5, precision="double")
    assert got.dtype == torch.float64 and got.shape == (2,)
    # with the OFDM overheads of the flagship's resource grid
    from sionna_tpu.phy.ofdm import ResourceGrid as JResourceGrid
    from sionna_tpu_torch.phy.ofdm import ResourceGrid
    kw = dict(num_ofdm_symbols=14, fft_size=256, subcarrier_spacing=30e3,
              cyclic_prefix_length=16, pilot_pattern="kronecker",
              pilot_ofdm_symbol_indices=[2, 11])
    want = np.asarray(jutils.ebnodb2no(jnp.float32(5.0), 4, 0.5,
                                       JResourceGrid(**kw)))
    got = tutils.ebnodb2no(5.0, 4, 0.5, resource_grid=ResourceGrid(**kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7)


def test_hard_decisions_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    llr = rng.normal(size=(50, 40)).astype(np.float32)
    llr[0, :3] = 0.0
    hd = tutils.hard_decisions(torch.as_tensor(llr))
    np.testing.assert_array_equal(
        hd.numpy(), np.asarray(jutils.hard_decisions(jnp.asarray(llr))))
    assert hd.dtype == torch.float32
    b = rng.integers(0, 2, (50, 40)).astype(np.float32)
    b_hat = b.copy()
    flips = rng.random(b.shape) < 0.01
    b_hat[flips] = 1 - b_hat[flips]
    tb, tbh = torch.as_tensor(b), torch.as_tensor(b_hat)
    jb, jbh = jnp.asarray(b), jnp.asarray(b_hat)
    assert int(tutils.count_errors(tb, tbh)) == \
        int(jutils.count_errors(jb, jbh))
    assert int(tutils.count_block_errors(tb, tbh)) == \
        int(jutils.count_block_errors(jb, jbh))
    # same integer counts divided in f64: exact
    assert float(tutils.compute_ber(tb, tbh)) == \
        float(jutils.compute_ber(jb, jbh))
    assert float(tutils.compute_bler(tb, tbh)) == \
        float(jutils.compute_bler(jb, jbh))
    assert tutils.compute_ber(tb, tbh, precision="single").dtype == \
        torch.float32


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import sionna_tpu_torch\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(sionna_tpu_torch.__path__,\n"
        "                               'sionna_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'sionna_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_matplotlib_only_where_it_plots():
    """Importing every module of the port leaves matplotlib out: each
    plot or show() imports it when it is called (the card's machine has
    none)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import sionna_tpu_torch\n"
        "for m in pkgutil.walk_packages(sionna_tpu_torch.__path__,\n"
        "                               'sionna_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('matplotlib', 'pylab'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# Public names of the JAX package that the port leaves out, each by the
# ROADMAP.md entry that says so. Subpackages that only hold data files
# (the LDPC and polar code tables, the turbo coefficients) are read by
# path and have no port counterpart.
PORT_EXCLUDES = {
    "sionna_tpu.phy.utils": {
        "put_complex",  # "Leave out": a TPU transfer workaround
    },
}


def _jax_subpackages():
    """(subpackages, data packages) of sionna_tpu; a data package has an
    ``__init__`` without code and no module."""
    import sionna_tpu
    names, data = ["sionna_tpu"], set()
    for m in pkgutil.walk_packages(sionna_tpu.__path__, "sionna_tpu."):
        if not m.ispkg:
            continue
        mod = importlib.import_module(m.name)
        if any(True for _ in pkgutil.iter_modules(mod.__path__)) \
                or any(not n.startswith("_") for n in dir(mod)):
            names.append(m.name)
        else:
            data.add(m.name)
    return names, data


def test_port_has_every_public_name_of_the_jax_package():
    """Every public name of each JAX subpackage exists in its port
    counterpart, but for PORT_EXCLUDES."""
    missing = {}
    names, data = _jax_subpackages()
    for name in names:
        jmod = importlib.import_module(name)
        tmod = importlib.import_module(
            name.replace("sionna_tpu", "sionna_tpu_torch", 1))
        public = {n for n in dir(jmod) if not n.startswith("_")
                  and f"{name}.{n}" not in data}
        lacking = sorted(public - PORT_EXCLUDES.get(name, set())
                         - set(dir(tmod)))
        if lacking:
            missing[name] = lacking
    assert not missing, missing
    from sionna_tpu import __version__ as jax_version
    import sionna_tpu_torch
    import sionna_tpu_torch.phy as tphy
    import sionna_tpu.phy as jphy
    assert sionna_tpu_torch.__version__ == jax_version
    for const in ("SPEED_OF_LIGHT", "BOLTZMANN_CONSTANT", "PI", "H",
                  "ALPHA_MAX"):
        assert getattr(tphy, const) == getattr(jphy, const)


PLOT_METHODS = ("show", "plot", "render", "preview", "show_topology")


def test_port_has_every_plot_and_show_method_of_the_jax_package():
    """Every class of the JAX package (its modules walked) with a
    ``show``, ``plot``, ``render``, ``preview`` or ``show_topology``
    method has it in its port counterpart, as a method."""
    import inspect
    import sionna_tpu
    found, missing = set(), []
    for m in pkgutil.walk_packages(sionna_tpu.__path__, "sionna_tpu."):
        jmod = importlib.import_module(m.name)
        for cname, cls in vars(jmod).items():
            if not inspect.isclass(cls) or cls.__module__ != m.name:
                continue
            for meth in PLOT_METHODS:
                if not callable(getattr(cls, meth, None)):
                    continue
                tmod = importlib.import_module(
                    m.name.replace("sionna_tpu", "sionna_tpu_torch", 1))
                tcls = getattr(tmod, cname, None)
                found.add(f"{cname}.{meth}")
                if not callable(getattr(tcls, meth, None)):
                    missing.append(f"{m.name}.{cname}.{meth}")
    assert not missing, missing
    # the ones the JAX package has today, PUSCHPilotPattern by inheritance
    assert {"Constellation.show", "ResourceGrid.show", "PilotPattern.show",
            "PUSCHPilotPattern.show", "Filter.show", "Window.show",
            "PanelArray.show", "SystemLevelChannel.show_topology",
            "PHYAbstraction.plot", "HexGrid.show", "RadioMap.show",
            "Scene.render", "Scene.preview"} <= found


def test_weighted_bp_callback_is_an_object():
    from sionna_tpu_torch.phy import Object
    from sionna_tpu_torch.phy.fec.ldpc import WeightedBPCallback
    cb = WeightedBPCallback(6, init=0.5, device="cpu")
    assert isinstance(cb, Object) and isinstance(cb, torch.nn.Module)
    assert cb.precision == "single" and cb.rdtype == torch.float32
    assert WeightedBPCallback(6, precision="double").cdtype == \
        torch.complex128
    assert [p.shape for p in cb.parameters()] == [(6,)]
    msg = torch.ones(2, 6)
    out = cb(msg, 0)
    out.sum().backward()
    assert torch.equal(out, torch.full((2, 6), 0.5))
    assert torch.equal(cb.weights.grad, torch.full((6,), 2.0))


def test_compute_ser_matches_jax():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 16, (40, 30))
    s_hat = s.copy()
    flips = rng.random(s.shape) < 0.07
    s_hat[flips] = (s_hat[flips] + 3) % 16
    for precision in ("double", "single"):
        want = jutils.compute_ser(jnp.asarray(s), jnp.asarray(s_hat),
                                  precision=precision)
        got = tutils.compute_ser(torch.as_tensor(s), torch.as_tensor(s_hat),
                                 precision=precision)
        assert got.dtype == dtypes[precision]["torch"]["rdtype"]
        assert float(got) == float(want)


def test_diag_parts_match_jax():
    x = np.random.default_rng(2).normal(size=(3, 4, 4, 5, 5))
    for axis in (0, 1, 3, -2, -4):
        if x.shape[axis] != x.shape[axis + 1 if axis >= 0 else axis + 1]:
            continue
        want = np.asarray(jutils.diag_part_axis(jnp.asarray(x), axis))
        got = tutils.diag_part_axis(torch.as_tensor(x), axis).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    c = x + 1j * x[::-1]
    np.testing.assert_array_equal(
        tutils.matrix_diag_part(torch.as_tensor(c)).numpy(),
        np.asarray(jutils.matrix_diag_part(jnp.asarray(c))))


def test_random_tensor_from_values_statistics():
    """Every entry drawn from the set, each value as often as the others
    (within 5 standard errors), on the device asked for."""
    values = [-3, 0, 2, 7, 11]
    g = torch.Generator().manual_seed(4)
    t = tutils.random_tensor_from_values(values, (200, 300), generator=g)
    assert t.shape == (200, 300) and t.device.type == "cpu"
    assert bool(tutils.tensor_values_are_in_set(t, values))
    n, k = t.numel(), len(values)
    p = 1 / k
    for v in values:
        count = int((t == v).sum())
        assert abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p)), (v, count)
    f = tutils.random_tensor_from_values(torch.tensor([0.5, 1.5]), (10,),
                                         dtype=torch.float64)
    assert f.dtype == torch.float64 and set(f.tolist()) <= {0.5, 1.5}
    a = tutils.random_tensor_from_values(values, (50,),
                                         generator=torch.Generator()
                                         .manual_seed(9))
    b = tutils.random_tensor_from_values(values, (50,),
                                         generator=torch.Generator()
                                         .manual_seed(9))
    assert torch.equal(a, b)


def test_inv_cholesky_is_exported_and_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 6, 6)) + 1j * rng.normal(size=(2, 6, 6))
    a = (a @ np.conj(np.swapaxes(a, -1, -2)) + 6 * np.eye(6)).astype(
        np.complex64)
    want = np.asarray(jutils.inv_cholesky(jnp.asarray(a)))
    got = tutils.inv_cholesky(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
