"""Every plot and ``show()`` of the PyTorch port against the JAX
package's, on the same inputs (matplotlib's Agg backend): ``plot_ber``,
``PlotBER`` (``add``, ``remove``, ``__call__``, ``simulate``), the EXIT
chart helpers, ``RadioMap.show``, ``Constellation``, ``ResourceGrid``,
``PilotPattern`` (and ``PUSCHPilotPattern``), ``Filter``, ``Window``,
the TR 38.901 panel array, ``SystemLevelChannel.show_topology``,
``PHYAbstraction.plot`` and ``HexGrid.show``.

The figures are compared artist by artist: each axes' title and labels,
limits, legend, the lines' data and style, the images' arrays and colour
maps, the scatter collections' offsets and the texts. Data are compared
to PLOT_RTOL (float32 values drawn from the same inputs: one ULP where
the two packages round differently); everything else exactly.
``PHYAbstraction.plot`` closes its figures, so its saved images are
compared pixel for pixel.
"""

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.image as mimage  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import sionna_tpu.phy as jphy  # noqa: E402
import sionna_tpu.phy.channel.tr38901 as jtr  # noqa: E402
import sionna_tpu.phy.fec.utils as jfec  # noqa: E402
import sionna_tpu.phy.nr as jnr  # noqa: E402
import sionna_tpu.phy.ofdm as jofdm  # noqa: E402
import sionna_tpu.phy.signal as jsig  # noqa: E402
import sionna_tpu.phy.utils as jutils  # noqa: E402
import sionna_tpu.rt as jrt  # noqa: E402
import sionna_tpu.sys as jsys  # noqa: E402
import sionna_tpu_torch.phy as tphy  # noqa: E402
import sionna_tpu_torch.phy.channel.tr38901 as ttr  # noqa: E402
import sionna_tpu_torch.phy.fec.utils as tfec  # noqa: E402
import sionna_tpu_torch.phy.nr as tnr  # noqa: E402
import sionna_tpu_torch.phy.ofdm as tofdm  # noqa: E402
import sionna_tpu_torch.phy.signal as tsig  # noqa: E402
import sionna_tpu_torch.phy.utils as tutils  # noqa: E402
import sionna_tpu_torch.rt as trt  # noqa: E402
import sionna_tpu_torch.sys as tsys  # noqa: E402
from sionna_tpu_torch.phy.config import config as torch_config  # noqa: E402

torch.set_num_threads(2)

PLOT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _axes_summary(ax):
    legend = ax.get_legend()
    summary = {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(),
        "ylabel": ax.get_ylabel(), "xlim": ax.get_xlim(),
        "ylim": ax.get_ylim(), "xscale": ax.get_xscale(),
        "yscale": ax.get_yscale(),
        "legend": None if legend is None
        else [t.get_text() for t in legend.get_texts()],
        "lines": [(ln.get_xdata(), ln.get_ydata(), ln.get_linestyle(),
                   ln.get_marker(), ln.get_label(), ln.get_color(),
                   ln.get_linewidth(), ln.get_markeredgecolor())
                  for ln in ax.get_lines()],
        "images": [(np.asarray(im.get_array()), im.get_cmap().name,
                    im.origin) for im in ax.get_images()],
        "collections": [np.asarray(getattr(c, "_offsets3d", None)
                                   or c.get_offsets())
                        for c in ax.collections],
        "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
    }
    if hasattr(ax, "get_zlabel"):
        summary["zlabel"] = ax.get_zlabel()
    return summary


def _summary(fig):
    return [_axes_summary(ax) for ax in fig.axes]


def _assert_same(got, want, where="figure"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (float, np.floating))):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, tuple, list)) or (
            isinstance(want, (float, np.floating))):
        g = np.asarray(got, np.float64)
        w = np.asarray(want, np.float64)
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g, w, rtol=PLOT_RTOL, atol=0,
                                   err_msg=where)
    else:
        assert got == want, where


def _same_figures(got, want):
    assert got is not want
    _assert_same(_summary(got), _summary(want))


def test_plot_ber_matches_jax(tmp_path):
    snr = np.arange(0., 5.)
    ber = np.array([[1e-1, 5e-2, 1e-2, 2e-3, 1e-4],
                    [2e-1, 1e-1, 5e-2, 1e-2, 3e-3]])
    kw = dict(legend=["a", "b"], ylabel="BLER", title="T", ebno=False,
              is_bler=[False, True], xlim=(0, 4), ylim=(1e-5, 1))
    jfig, jax_ = jutils.plot_ber(snr, ber, **kw)
    tfig, tax = tutils.plot_ber(torch.as_tensor(snr), torch.as_tensor(ber),
                                **kw)
    assert tax is tfig.axes[0] and jax_ is jfig.axes[0]
    _same_figures(tfig, jfig)
    for mod in (jutils, tutils):
        path = str(tmp_path / f"{mod.__name__}.png")
        fig, _ = mod.plot_ber(snr, ber[0], legend="x", is_bler=True,
                              save_fig=True, path=path)
        assert os.path.isfile(path) and not plt.fignum_exists(fig.number)
    np.testing.assert_array_equal(
        mimage.imread(str(tmp_path / f"{tutils.__name__}.png")),
        mimage.imread(str(tmp_path / f"{jutils.__name__}.png")))


def test_plot_ber_class_matches_jax():
    figs = []
    for mod, arr in ((jutils, np.asarray), (tutils, torch.as_tensor)):
        pb = mod.PlotBER("curves")
        pb.add(arr(np.arange(3.)), arr(np.array([0.1, 0.01, 0.001])),
               legend="first")
        pb.add(np.arange(4.), np.array([0.3, 0.1, 0.05, 0.02]),
               is_bler=True, legend="second")
        pb.add([0., 1.], [0.5, 0.4], legend="dropped")
        pb.remove(-1)
        assert pb.legend == ["first", "second"] and pb.is_bler == [False,
                                                                  True]
        assert [len(s) for s in pb.snr] == [3, 4]
        np.testing.assert_array_equal(pb.ber[0], [0.1, 0.01, 0.001])
        figs.append([pb()[0], pb(show_bler=False)[0],
                     pb(show_ber=False, xlim=(0, 3))[0]])
        assert pb(show_ber=False, show_bler=False) is None
        pb.reset()
        assert pb.ber == [] and pb() is None
    for want, got in zip(*figs):
        _same_figures(got, want)


def test_plot_ber_simulate_matches_jax():
    """``simulate`` on deterministic links (a fixed error pattern per
    SNR), so both packages' ``sim_ber`` count the same errors."""
    def jax_link(batch_size, ebno_db):
        b = jnp.zeros((batch_size, 10))
        cut = jnp.where(ebno_db < 1.5, 4, 1)
        return b, (jnp.arange(10) < cut).astype(jnp.float32) * \
            jnp.ones((batch_size, 1))

    def torch_link(batch_size, ebno_db):
        b = torch.zeros(batch_size, 10)
        cut = 4 if ebno_db < 1.5 else 1
        return b, (torch.arange(10) < cut).float().expand(batch_size, 10)

    figs, results = [], []
    for mod, link in ((jutils, jax_link), (tutils, torch_link)):
        pb = mod.PlotBER()
        ber, bler = pb.simulate(link, [1., 2.], batch_size=8, max_mc_iter=2,
                                legend="link", add_bler=True, show_fig=True,
                                verbose=False)
        results.append((np.asarray(ber), np.asarray(bler)))
        assert pb.legend == ["link", "link (BLER)"]
        figs.append(plt.gcf())
    np.testing.assert_array_equal(results[1][0], [0.4, 0.1])
    for got, want in zip(results[1], results[0]):
        np.testing.assert_array_equal(got, want)
    _same_figures(figs[1], figs[0])


def test_exit_chart_helpers_match_jax():
    """The EXIT chart as JAX draws it; the port's trajectory is the
    staircase JAX's ``plot_trajectory`` means to draw (JAX's raises: it
    hands matplotlib 2n - 1 x values for 2n y values)."""
    pcm = jfec.load_parity_check_examples(0)[0]
    figs = []
    for mod in (jfec, tfec):
        mi_a, mi_ev, mi_ec = mod.get_exit_analytic(pcm, 1.0)
        plot = mod.plot_exit_chart(mi_a, mi_ev, mi_ec, title="EXIT")
        figs.append(plot.gcf())
    _same_figures(figs[1], figs[0])
    with pytest.raises(ValueError, match="same first dimension"):
        jfec.plot_trajectory(plt, [0.1, 0.3], [0.2, 0.5])
    tfec.plot_trajectory(plt, torch.tensor([0.1, 0.3, 0.6]),
                         [0.2, 0.5, 0.9], ebno=1.0)
    line = figs[1].axes[0].get_lines()[-1]
    np.testing.assert_allclose(line.get_xdata(),
                               [0.1, 0.1, 0.3, 0.3, 0.6, 0.6], rtol=1e-7)
    np.testing.assert_array_equal(line.get_ydata(),
                                  [0., 0.2, 0.2, 0.5, 0.5, 0.9])
    assert line.get_label() == "Trajectory @ 1.0 dB"
    assert [t.get_text() for t in figs[1].axes[0].get_legend()
            .get_texts()] == ["VND", "CND", "Trajectory @ 1.0 dB"]
    with pytest.raises(ValueError, match="same length"):
        tfec.plot_trajectory(plt, [0.1, 0.2], [0.1])


def test_radio_map_show_matches_jax():
    pg = np.random.default_rng(0).random((2, 5, 7)) * 1e-9
    pg[0, 0, 0] = 0.
    cells = np.zeros((5, 7, 3))
    jrm = jrt.RadioMap(jnp.asarray(pg), cells, [40., 44.])
    trm = trt.RadioMap(torch.as_tensor(pg), cells, [40., 44.])
    for kw in (dict(), dict(metric="rss", tx=1), dict(metric="sinr")):
        _same_figures(trm.show(**kw), jrm.show(**kw))


def test_constellation_show_matches_jax():
    for labels in (True, False):
        jfig = jphy.Constellation("qam", 4).show(labels=labels)
        tfig = tphy.Constellation("qam", 4).show(labels=labels,
                                                 figsize=(7, 7))
        _same_figures(tfig, jfig)
    assert len(tfig.axes[0].texts) == 0


def _resource_grids(mod):
    return mod.ResourceGrid(num_ofdm_symbols=14, fft_size=24,
                            subcarrier_spacing=30e3, num_tx=2,
                            num_streams_per_tx=2,
                            pilot_pattern="kronecker",
                            pilot_ofdm_symbol_indices=[2, 11],
                            num_guard_carriers=(2, 1), dc_null=True)


def test_resource_grid_and_pilot_patterns_show_match_jax():
    jrg, trg = _resource_grids(jofdm), _resource_grids(tofdm)
    _same_figures(trg.show(tx_ind=1, tx_stream_ind=1),
                  jrg.show(tx_ind=1, tx_stream_ind=1))
    for kw in (dict(), dict(tx_ind=1, stream_ind=0)):
        tfigs = trg.pilot_pattern.show(**kw)
        jfigs = jrg.pilot_pattern.show(**kw)
        assert len(tfigs) == len(jfigs) == (4 if not kw else 1)
        for got, want in zip(tfigs, jfigs):
            _same_figures(got, want)
    pcs = []
    for nr in (jnr, tnr):
        pc = nr.PUSCHConfig()
        pc.num_antenna_ports = 2
        pc.num_layers = 2
        pc.carrier.n_size_grid = 4
        pcs.append(nr.PUSCHPilotPattern(pc))
    for got, want in zip(pcs[1].show(), pcs[0].show()):
        _same_figures(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(response="magnitude"),
                                dict(response="magnitude", scale="db")])
def test_filter_show_matches_jax(kw):
    figs = []
    for mod in (jsig, tsig):
        filt = mod.RootRaisedCosineFilter(8, 4, 0.3,
                                          window=mod.HannWindow())
        filt.show(**kw)
        figs.append(plt.gcf())
    _same_figures(figs[1], figs[0])


@pytest.mark.parametrize("kw", [dict(), dict(domain="frequency"),
                                dict(domain="frequency", scale="db")])
def test_window_show_matches_jax(kw):
    """A window that made its coefficients for a 33-sample input, and a
    custom one."""
    coeffs = np.random.default_rng(1).random(20)
    for make, ones in ((lambda mod: mod.BlackmanWindow(), (1, 33)),
                       (lambda mod: mod.CustomWindow(coeffs), (1, 20))):
        figs = []
        for mod, arr in ((jsig, jnp.ones), (tsig, torch.ones)):
            win = make(mod)
            win(arr(ones))
            win.show(4, **kw)
            figs.append(plt.gcf())
        _same_figures(figs[1], figs[0])


def test_panel_array_show_matches_jax():
    for args in ((2, 4, "dual", "cross", "38.901"),
                 (1, 2, "single", "V", "omni")):
        jfig = jtr.AntennaArray(*args, carrier_frequency=3.5e9).show()
        tfig = ttr.AntennaArray(*args, carrier_frequency=3.5e9).show()
        _same_figures(tfig, jfig)


def test_show_topology_matches_jax():
    topo = jphy.channel.gen_single_sector_topology(2, 12, "umi")
    topo = [np.asarray(x) for x in topo]
    figs = []
    for tr, arr in ((jtr, jnp.asarray), (ttr, torch.as_tensor)):
        ut = tr.PanelArray(1, 1, "single", "V", "omni", 3.5e9)
        bs = tr.PanelArray(1, 1, "single", "V", "omni", 3.5e9)
        model = tr.UMi(3.5e9, "low", ut, bs, "downlink")
        model.set_topology(*[arr(x) for x in topo])
        if tr is ttr:  # JAX's LoS draw: the packages' streams differ
            model._scenario._los = np.asarray(jax_los)
        jax_los = model._scenario.los
        figs.append(model.show_topology(bs_index=0, batch_index=1))
    _same_figures(figs[1], figs[0])
    assert figs[1].axes[0].get_legend() is not None


def test_phy_abstraction_plot_matches_jax(tmp_path):
    subset = {"category": {1: {"index": {1: {"MCS": [3, 14]}}}}}
    names = {}
    for mod in (jsys, tsys):
        out = str(tmp_path / mod.__name__)
        names[mod] = mod.PHYAbstraction().plot(plot_subset=subset,
                                               show=False, save_path=out)
        assert len(names[mod]) == 2
        assert not plt.get_fignums()
    for got, want in zip(names[tsys], names[jsys]):
        assert os.path.basename(got) == os.path.basename(want)
        np.testing.assert_array_equal(mimage.imread(got),
                                      mimage.imread(want))
    assert tsys.PHYAbstraction().plot(
        plot_subset={"category": {1: {"index": {1: {"MCS": 99}}}}},
        show=False) == []


def test_hexgrid_show_matches_jax():
    for kw in (dict(), dict(show_mirrors=True)):
        jfig = jsys.HexGrid(1, isd=200.).show(**kw)
        tfig = tsys.HexGrid(1, isd=200.).show(**kw)
        _same_figures(tfig, jfig)
    fig = plt.figure()
    assert tsys.HexGrid(1, isd=100.).show(fig=fig, label=None,
                                          color="g") is fig
