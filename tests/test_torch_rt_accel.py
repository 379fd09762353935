"""The ray tracer's geometry and acceleration structure in the PyTorch
port against the JAX package, on the CPU (float64 geometry in both):
the cluster builders, ``build_accel``'s arrays, the accelerated nearest
hit and occlusion queries (at the default ``k_max`` and at ``k_max=2``,
which sends most ray chunks through the dense repair sweep), the
through-blocker transmission products, Moller-Trumbore, ``trace`` and
``trace_unique``.

Tolerances:
- builders, accel arrays, occlusion verdicts, traced ids: exact;
- hit distances: T_ATOL (the same float64 arithmetic in another order);
- hit ids: equal wherever the nearest hit's distance is unique (two
  triangles sharing an edge can tie, and then either id is right);
- transmission products: PROD_ATOL (products of up to ~40 complex64
  slab factors, each rounded in its own order; the products are at most
  1 in magnitude).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.rt.accel as jaccel
import sionna_tpu.rt.em as jem
import sionna_tpu.rt.geometry as jgeo
import sionna_tpu.rt as jrt
import sionna_tpu_torch.rt.accel as taccel
import sionna_tpu_torch.rt.em as tem
import sionna_tpu_torch.rt.geometry as tgeo
from sionna_tpu_torch._build import BUILD_DIR

torch.set_num_threads(2)

T_ATOL = 1e-12
PROD_ATOL = 1e-5


def _soup(num_tri, seed, extent=50.):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-extent, extent, (num_tri, 1, 3))
    return base + rng.uniform(-2., 2., (num_tri, 3, 3))


def _rays(num_rays, seed, extent=60., length=None):
    """Rays from a box of half-width ``extent`` towards points of the
    soup's central region."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (num_rays, 3))
    d = rng.uniform(-20., 20., (num_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if length is not None:
        d *= length
    return o, d


def _t(x):
    return torch.as_tensor(np.array(x))


def _unique_t(orig, dirs, tri, t_min):
    """Rays whose nearest hit distance belongs to one triangle only."""
    t, hit = tgeo.moller_trumbore(_t(orig), _t(dirs), _t(tri))
    t = torch.where(hit, t, torch.inf).numpy()
    return np.sum(t == t_min[:, None], axis=1) == 1


def test_native_builder_matches_jax_and_builds_into_build_dir():
    tri = _soup(2000, 1)
    for size in (16, 64):
        got = taccel.cluster_permutation(tri, size)
        want = jaccel.cluster_permutation(tri, size)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    lib = taccel.BVH_BUILDER.build()
    assert lib.parent == BUILD_DIR and lib.exists()


def test_numpy_builder_matches_jax():
    tri = _soup(777, 2)
    got = taccel._cluster_permutation_numpy(tri.astype(np.float32), 32)
    want = jaccel._cluster_permutation_numpy(tri.astype(np.float32), 32)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(777))


def test_build_accel_matches_jax():
    tri = _soup(1000, 3)
    got = taccel.build_accel(tri, "cpu", cluster_size=64)
    want = jaccel.build_accel(tri, cluster_size=64)
    for name in ("tri_c", "old_id", "lo", "hi"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert taccel.build_accel(tri, "cpu", cluster_size=64) is got


@pytest.mark.parametrize("k_max", [32, 2])
def test_nearest_hit_accel_matches_jax(k_max):
    tri = _soup(1500, 4, extent=25.)
    orig, dirs = _rays(300, 5)
    got_t, got_i, got_h = taccel.nearest_hit_accel(
        _t(orig), _t(dirs), taccel.build_accel(tri, "cpu"), ray_chunk=128,
        k_max=k_max)
    want_t, want_i, want_h = jaccel.nearest_hit_accel(
        jnp.asarray(orig), jnp.asarray(dirs), jaccel.build_accel(tri),
        ray_chunk=128, k_max=k_max)
    want_t = np.asarray(want_t)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    hit = np.asarray(want_h)
    assert 20 < hit.sum() < 300
    np.testing.assert_allclose(got_t.numpy()[hit], want_t[hit], rtol=0,
                               atol=T_ATOL)
    uniq = hit & _unique_t(orig, dirs, tri, want_t)
    np.testing.assert_array_equal(got_i.numpy()[uniq],
                                  np.asarray(want_i)[uniq])
    # the dense sweep agrees too
    dense_t, _, _ = tgeo.nearest_hit(_t(orig), _t(dirs), _t(tri))
    np.testing.assert_allclose(dense_t.numpy()[hit], want_t[hit], rtol=0,
                               atol=T_ATOL)


@pytest.mark.parametrize("k_max", [32, 2])
def test_any_blocking_hit_accel_matches_jax(k_max):
    tri = _soup(1500, 6, extent=25.)
    orig, dirs = _rays(400, 7, extent=30., length=30.)
    excl = np.random.default_rng(8).integers(-1, 1500, (400, 2))
    got = taccel.any_blocking_hit_accel(
        _t(orig), _t(dirs), taccel.build_accel(tri, "cpu"),
        excl_ids=_t(excl), ray_chunk=128, k_max=k_max).numpy()
    want = np.asarray(jaccel.any_blocking_hit_accel(
        jnp.asarray(orig), jnp.asarray(dirs), jaccel.build_accel(tri),
        excl_ids=jnp.asarray(excl, jnp.int32), ray_chunk=128,
        k_max=k_max))
    np.testing.assert_array_equal(got, want)
    assert 20 < want.sum() < 380
    dense = tgeo.any_blocking_hit(_t(orig), _t(dirs), _t(tri),
                                  excl_ids=_t(excl)).numpy()
    np.testing.assert_array_equal(dense, want)


def _materials(num_tri, seed):
    rng = np.random.default_rng(seed)
    eta = (rng.uniform(2., 8., num_tri)
           - 1j * rng.uniform(0.01, 1., num_tri)).astype(np.complex64)
    th = rng.uniform(0., 0.3, num_tri).astype(np.float32)
    th[::7] = 0.
    return eta, th


@pytest.mark.parametrize("accel", [False, True])
def test_transmission_products_match_jax(accel):
    tri = _soup(1500, 9, extent=20.)
    orig, dirs = _rays(256, 10, extent=25., length=30.)
    eta, th = _materials(1500, 11)
    e_a, e_b = tgeo.sph_basis(_t(dirs / np.linalg.norm(dirs, axis=-1,
                                                       keepdims=True)))
    lam = 0.1
    t_acc = taccel.build_accel(tri, "cpu") if accel else None
    j_acc = jaccel.build_accel(tri) if accel else None
    got_s = tem.transmission_product(_t(orig), _t(dirs), _t(tri), _t(eta),
                                     _t(th), lam, accel=t_acc).numpy()
    want_s = np.asarray(jem.transmission_product(
        jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(tri), eta,
        jnp.asarray(th), lam, accel=j_acc))
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=PROD_ATOL)
    got_j = tem.transmission_jones_product(
        _t(orig), _t(dirs), _t(tri), _t(eta), _t(th), lam, e_a, e_b,
        accel=t_acc).numpy()
    want_j = np.asarray(jem.transmission_jones_product(
        jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(tri), eta,
        jnp.asarray(th), lam, jnp.asarray(e_a.numpy()),
        jnp.asarray(e_b.numpy()), accel=j_acc))
    np.testing.assert_allclose(got_j, want_j, rtol=0, atol=PROD_ATOL)
    # most segments cross a blocker
    assert np.mean(np.abs(want_s - 1.) > 1e-3) > 0.3


def test_moller_trumbore_matches_jax():
    tri = _soup(300, 12)
    orig, dirs = _rays(200, 13)
    got_t, got_h = tgeo.moller_trumbore(_t(orig), _t(dirs), _t(tri))
    want_t, want_h = jgeo.moller_trumbore(
        jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(tri))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    h = np.asarray(want_h)
    np.testing.assert_allclose(got_t.numpy()[h], np.asarray(want_t)[h],
                               rtol=0, atol=T_ATOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ray_through_a_shared_edge_hits_both_triangles(dtype):
    """A segment of the canyon's radio map (from a reflection on the wall
    at y = -10 to the cell at (53.5, 13.5, 1.5)) crosses the building's
    end wall x = 50 exactly on the diagonal its two triangles share. All
    three Moller-Trumbore tests (geometry, the blocker candidates, the
    accel's per-ray test) hit the same triangles as JAX's float64 test,
    also in float32, the card's geometry dtype (edge_tol)."""
    tri = jrt.load_scene("simple_street_canyon").triangles
    tx, rx = np.array([-20., 0., 10.]), np.array([53.5, 13.5, 1.5])
    image = tx * [1., -1., 1.] + [0., -20., 0.]
    p = image + (rx - image) * 10. / (rx[1] - image[1])
    orig, dirs = p[None], (rx - p)[None]
    _, want = jgeo.moller_trumbore(jnp.asarray(orig), jnp.asarray(dirs),
                                   jnp.asarray(tri))
    want = np.nonzero(np.asarray(want)[0])[0].tolist()
    assert want == [5, 10, 11]
    o, d, tr = (torch.as_tensor(x, dtype=dtype) for x in (orig, dirs, tri))
    _, hit = tgeo.moller_trumbore(o, d, tr)
    assert torch.nonzero(hit[0])[:, 0].tolist() == want
    _, hit = taccel._mt_per_ray(o, d, tr[None])
    assert torch.nonzero(hit[0])[:, 0].tolist() == want
    cand = tem.blocker_candidates(
        o, d, d / torch.linalg.norm(d), tr, None,
        torch.arange(tri.shape[0]), torch.ones(tri.shape[0]))
    assert torch.nonzero(cand["eid"][0] >= 0)[:, 0].tolist() == want


@pytest.mark.parametrize("name", ["box", "city"])
def test_trace_and_trace_unique_match_jax(name):
    if name == "box":
        tri = jrt.load_scene("box").triangles
        o = np.array([1., -2., 1.5])
        acc = (None, None)
    else:
        tri = jrt.make_city(3, 3, subdiv=4).triangles
        o = np.array([0., 0., 20.])
        acc = (taccel.build_accel(tri, "cpu"), jaccel.build_accel(tri))
    dirs = tgeo.fibonacci_sphere(1500)
    orig = np.broadcast_to(o, dirs.shape)
    tri_t = _t(tri)
    normals = tgeo.tri_normals(tri_t)
    j_normals = jgeo.tri_normals(jnp.asarray(tri))
    got = tgeo.trace(tri_t, normals, _t(orig), _t(dirs), 3, acc[0])
    want = np.asarray(jgeo.trace(jnp.asarray(tri), j_normals,
                                 jnp.asarray(orig), jnp.asarray(dirs), 3,
                                 acc[1]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 2] >= 0).sum() > 100
    uniq, counts = tgeo.trace_unique(tri_t, normals, _t(orig), _t(dirs), 3,
                                     400, acc[0])
    juniq, jcounts = jgeo.trace_unique(
        jnp.asarray(tri), j_normals, jnp.asarray(orig), jnp.asarray(dirs),
        3, 400, acc[1])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    for g, w in zip(uniq, juniq):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # np.unique's order, and the cap
    for d, n in zip(range(1, 4), counts.tolist()):
        pref = want[:, :d][np.all(want[:, :d] >= 0, axis=1)]
        ref = np.unique(pref, axis=0)[:400]
        assert n == ref.shape[0]
        np.testing.assert_array_equal(uniq[d - 1].numpy()[:n], ref)


def test_trace_unique_pads_past_the_count():
    tri = jrt.load_scene("simple_reflector").triangles
    dirs = tgeo.fibonacci_sphere(64)
    orig = np.broadcast_to(np.array([0., 0., 3.]), dirs.shape)
    tri_t = _t(tri)
    uniq, counts = tgeo.trace_unique(tri_t, tgeo.tri_normals(tri_t),
                                     _t(orig), _t(dirs), 2, 8)
    assert counts.tolist() == [2, 0]
    assert (uniq[0][2:] == -1).all() and (uniq[1] == -1).all()
