"""GPU traversal kernel (ops/traverse_gpu.py) vs the XLA reference
``_traverse`` and a numpy brute-force oracle.  On the CPU the kernel runs
in Pallas interpret mode; ``test_compiled_kernel_matches_reference`` runs
the compiled kernel and needs the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shimmer_tpu.ops.traverse_gpu import BLOCK, _stack_depth, traverse_gpu_raw
from shimmer_tpu.shapes.triangle import (
    _traverse,
    _traverse_raw,
    build_triangle_scene,
    intersect_triangle,
)


def _random_mesh(rng, n_tri=200, spread=2.0, size=0.3):
    c = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, size, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, size, (n_tri, 3)).astype(np.float32)
    p = np.concatenate([c, c + e1, c + e2], axis=0)
    idx = np.stack(
        [np.arange(n_tri), np.arange(n_tri) + n_tri, np.arange(n_tri) + 2 * n_tri],
        axis=1,
    ).astype(np.int32)
    return {"p": p, "indices": idx}


def _rays(rng, n=256, spread=2.0):
    """Rays from outside the mesh's box, aimed near its triangles so that
    most of them hit."""
    o = rng.uniform(-3 * spread, 3 * spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def scene_and_rays():
    rng = np.random.default_rng(7)
    tris = build_triangle_scene([_random_mesh(rng)])
    o, d = _rays(rng)
    return tris, o, d


def _kernel(tris, o, d, t_max, any_hit=False):
    t, tri = traverse_gpu_raw(tris, o, d, t_max, any_hit, interpret=True)
    return np.asarray(t), np.asarray(tri)


def _reference(tris, o, d, t_max, any_hit=False):
    t, tri = _traverse(tris, o, d, t_max, any_hit=any_hit, raw=True)
    return np.asarray(t), np.asarray(tri)


def _brute(tris, o, d, t_max):
    """Closest hit over all triangles via the same watertight test."""
    idx = tris.indices
    p0 = tris.p[idx[:, 0]]
    p1 = tris.p[idx[:, 1]]
    p2 = tris.p[idx[:, 2]]
    hit, t, *_ = intersect_triangle(
        o[:, None, :], d[:, None, :], jnp.asarray(t_max)[..., None],
        p0[None], p1[None], p2[None],
    )
    return np.asarray(jnp.min(jnp.where(hit, t, jnp.inf), axis=1))


@pytest.mark.parametrize("n", [BLOCK, 2 * BLOCK, 256])
def test_closest_hit_matches_reference_and_brute(scene_and_rays, n):
    tris, o, d = scene_and_rays
    o, d = o[:n], d[:n]
    t_max = jnp.full(n, jnp.inf)
    tk, trik = _kernel(tris, o, d, t_max)
    tx, trix = _reference(tris, o, d, t_max)
    tb = _brute(tris, o, d, t_max)
    hit = trik >= 0
    assert hit.sum() > n // 4, "fixture rays should mostly hit"
    np.testing.assert_array_equal(trik, trix)
    np.testing.assert_array_equal(tk, tx)
    assert (hit == np.isfinite(tb)).all()
    assert np.isinf(tk[~hit]).all()
    np.testing.assert_allclose(tk[hit], tb[hit], rtol=1e-5)


def test_any_hit_finds_exactly_the_occluded_rays(scene_and_rays):
    tris, o, d = scene_and_rays
    t_max = jnp.full(o.shape[0], jnp.inf)
    _, tri_any = _kernel(tris, o, d, t_max, any_hit=True)
    _, tri_ref = _reference(tris, o, d, t_max, any_hit=True)
    _, tri_closest = _reference(tris, o, d, t_max)
    np.testing.assert_array_equal(tri_any, tri_ref)
    np.testing.assert_array_equal(tri_any >= 0, tri_closest >= 0)


def test_t_max_clips_hits(scene_and_rays):
    tris, o, d = scene_and_rays
    t_full, tri_full = _kernel(tris, o, d, jnp.full(o.shape[0], jnp.inf))
    hit = tri_full >= 0
    # Clip each hit ray halfway to its nearest hit: nothing is nearer.
    t_clip = jnp.asarray(np.where(hit, 0.5 * t_full, np.inf), jnp.float32)
    _, tri_c = _kernel(tris, o, d, t_clip)
    assert (tri_c[hit] == -1).all()
    np.testing.assert_array_equal(tri_c[~hit], tri_full[~hit])
    # Clipping just past the hit keeps it.
    t_keep = jnp.asarray(np.where(hit, 1.001 * t_full, np.inf), jnp.float32)
    _, tri_k = _kernel(tris, o, d, t_keep)
    np.testing.assert_array_equal(tri_k, tri_full)


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK + 1, 77, 130])
def test_ray_count_not_a_multiple_of_block(scene_and_rays, n):
    tris, o, d = scene_and_rays
    t_max = jnp.full(n, jnp.inf)
    tk, trik = _kernel(tris, o[:n], d[:n], t_max)
    tx, trix = _reference(tris, o[:n], d[:n], t_max)
    assert trik.shape == (n,) and tk.shape == (n,)
    np.testing.assert_array_equal(trik, trix)
    np.testing.assert_array_equal(tk, tx)


def test_mixed_any_hit_closest_and_dead_lanes(scene_and_rays):
    """The wavefront's merged trace: per-lane any-hit flags, finite shadow
    t_max, and dead lanes with t_max = -inf."""
    tris, o, d = scene_and_rays
    n = o.shape[0]
    rng = np.random.default_rng(11)
    want = rng.random(n) < 0.5
    t_max = np.where(want, rng.uniform(0.5, 8.0, n), np.inf)
    dead = rng.random(n) < 0.3
    t_max = jnp.asarray(np.where(dead, -np.inf, t_max).astype(np.float32))
    want = jnp.asarray(want)
    tk, trik = _kernel(tris, o, d, t_max, any_hit=want)
    tx, trix = _reference(tris, o, d, t_max, any_hit=want)
    np.testing.assert_array_equal(trik, trix)
    np.testing.assert_array_equal(tk, tx)
    assert (trik[dead] == -1).all() and np.isinf(tk[dead]).all()


def test_deep_stack_scene():
    """Forty nested shells of triangles, each half the size of the last:
    a deep tree whose stack needs more slots than the fixture's."""
    rng = np.random.default_rng(3)
    n_tri = 3000
    scale = 0.5 ** (np.arange(n_tri) % 40)
    c = (scale[:, None] * rng.uniform(-1, 1, (n_tri, 3))).astype(np.float32)
    e1 = (scale[:, None] * rng.normal(0, 0.05, (n_tri, 3))).astype(np.float32)
    e2 = (scale[:, None] * rng.normal(0, 0.05, (n_tri, 3))).astype(np.float32)
    idx = np.arange(3 * n_tri, dtype=np.int32).reshape(3, n_tri).T
    tris = build_triangle_scene(
        [{"p": np.concatenate([c, c + e1, c + e2]), "indices": idx}]
    )
    assert tris.stack_depth + 2 > 8, tris.stack_depth
    assert _stack_depth(tris) >= tris.stack_depth + 2
    # Aim at triangle centroids across all shells.
    o = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    target = (c + (e1 + e2) / 3)[rng.integers(0, n_tri, 200)]
    d = target - o
    o, d = jnp.asarray(o), jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    want = jnp.asarray(np.arange(200) % 3 == 0)
    t_max = jnp.full(200, jnp.inf)
    tk, trik = _kernel(tris, o, d, t_max, any_hit=want)
    tx, trix = _reference(tris, o, d, t_max, any_hit=want)
    assert (trik >= 0).sum() > 100
    np.testing.assert_array_equal(trik, trix)
    np.testing.assert_array_equal(tk, tx)


@pytest.mark.parametrize("need,slots", [(3, 8), (8, 8), (9, 16), (17, 32)])
def test_stack_slots_are_a_power_of_two(need, slots):
    tris = type("T", (), {"stack_depth": need - 2})()
    assert _stack_depth(tris) == slots


def _has_pallas_call(tris, o, d):
    jaxpr = jax.make_jaxpr(
        lambda o, d: _traverse_raw(tris, o, d, jnp.inf, False)
    )(o, d)
    return "pallas_call" in str(jaxpr)


@pytest.mark.parametrize(
    "traversal,kernel", [("auto", False), ("xla", False), ("interpret", True)]
)
def test_backend_choice_on_cpu(scene_and_rays, traversal, kernel):
    """On the CPU "auto" and "xla" take the XLA reference; only an
    explicit "interpret" runs the kernel."""
    tris, o, d = scene_and_rays
    tris = dataclasses.replace(tris, traversal=traversal)
    assert _has_pallas_call(tris, o, d) == kernel
    t, tri = _traverse_raw(tris, o, d, jnp.inf, False)
    tx, trix = _reference(tris, o, d, jnp.inf)
    np.testing.assert_array_equal(np.asarray(tri), trix)


def test_unknown_traversal_is_an_error(scene_and_rays):
    tris, o, d = scene_and_rays
    tris = dataclasses.replace(tris, traversal="pallas")
    with pytest.raises(ValueError, match="unknown traversal"):
        _traverse_raw(tris, o, d, jnp.inf, False)


def test_replay_gradient_through_kernel_equals_reference():
    """Path-replay value-and-grad w.r.t. a reflectance on a triangle
    scene: the kernel (interpret mode) and the XLA reference give the
    same value and gradient."""
    from shimmer_tpu.render import (
        full_image_pixels,
        make_replay_wavefront_renderer,
    )
    from shimmer_tpu.samplers import IndependentSampler
    from test_grad import TestProductionScaleGradients

    scene, cam, film = TestProductionScaleGradients._tri_scene(res=16)
    sampler = IndependentSampler(2)
    pixel_xy = full_image_pixels(film)
    valid = jnp.ones(pixel_xy.shape[0], bool)
    idx = jnp.arange(2, dtype=jnp.uint32)

    def value_and_grad(traversal):
        tris = dataclasses.replace(scene.triangles, traversal=traversal)
        sc0 = dataclasses.replace(scene, triangles=tris)
        replay = make_replay_wavefront_renderer(
            sc0, cam, film, sampler, max_depth=3
        )

        def loss(theta):
            mats = dataclasses.replace(
                sc0.materials,
                reflectance=sc0.materials.reflectance.at[0, 1].set(theta),
            )
            sc = dataclasses.replace(sc0, materials=mats)
            fs = replay(sc, film.init_state(), idx, pixel_xy, valid)
            return jnp.sum(fs.rgb_sum) / pixel_xy.shape[0]

        return jax.jit(jax.value_and_grad(loss))(jnp.float32(0.45))

    v_k, g_k = value_and_grad("interpret")
    v_x, g_x = value_and_grad("xla")
    assert abs(float(g_x)) > 1e-6
    np.testing.assert_allclose(float(v_k), float(v_x), rtol=1e-6)
    np.testing.assert_allclose(float(g_k), float(g_x), rtol=1e-6)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu, scene_and_rays):
    tris, o, d = scene_and_rays
    n = o.shape[0]
    want = jnp.asarray(np.arange(n) % 2 == 0)
    t_max = jnp.full(n, jnp.inf)
    tk, trik = traverse_gpu_raw(tris, o, d, t_max, want)
    tx, trix = _reference(tris, o, d, t_max, any_hit=want)
    trik = np.asarray(trik)
    # Closest-hit lanes: same winner; any-hit lanes: same occlusion.
    closest = ~np.asarray(want)
    np.testing.assert_array_equal(trik[closest], trix[closest])
    np.testing.assert_array_equal(trik >= 0, trix >= 0)
    hit = closest & (trik >= 0)
    np.testing.assert_allclose(np.asarray(tk)[hit], tx[hit], rtol=1e-5)
