"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(the multi-node substitute SURVEY.md §4 prescribes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shimmer_tpu.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu.color.colorspace import get_named_color_space
from shimmer_tpu.film.filters import BoxFilter
from shimmer_tpu.film.film import PixelSensor, RgbFilm
from shimmer_tpu.lights import lights as lt
from shimmer_tpu.materials import material as mtl
from shimmer_tpu.ops.transform import Transform
from shimmer_tpu.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu.render import render
from shimmer_tpu.samplers import IndependentSampler
from shimmer_tpu.scene_builder import build_scene
from shimmer_tpu.spectra.spectrum import ConstantSpectrum


@pytest.fixture(scope="module")
def setup():
    cs = get_named_color_space("srgb")
    res = 32
    ct = CameraTransform(
        Transform.look_at(
            jnp.array([0.0, 0.0, -4.0]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])
        )
    )
    cam = PerspectiveCamera(ct, (res, res), fov=45.0)
    film = RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(
        spheres=[
            {"radius": 1.0, "material_id": 0},
            {
                "radius": 0.3,
                "material_id": 1,
                "area_light_id": 0,
                "object_to_world": Transform.translate(jnp.array([0.0, 2.0, 0.0])),
            },
        ],
        materials=[
            {"kind": mtl.DIFFUSE, "reflectance": [0.8, 0.4, 0.2]},
            {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
        ],
        lights=[
            {
                "kind": lt.AREA,
                "spectrum": ConstantSpectrum(40.0),
                "shape_kind": 0,
                "shape_idx": 1,
            }
        ],
        render_from_world=cam.camera_transform.render_from_world(),
    )
    return scene, cam, film


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestShardedRender:
    def test_tile_sharding_matches_single_chip(self, setup):
        scene, cam, film = setup
        spp = 16
        ref, _ = render(
            scene, cam, film, IndependentSampler(spp), "path", spp=spp,
            max_depth=3, wave_spp=8,
        )
        mesh = make_tile_mesh()
        img, state = render_sharded(
            scene, cam, film, IndependentSampler(spp), mesh, "path", spp=spp,
            max_depth=3, wave_spp=8, mode="tiles",
        )
        # Identical sampler streams ⇒ bit-identical images.
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), rtol=1e-5, atol=1e-5
        )

    def test_spp_sharding_unbiased(self, setup):
        scene, cam, film = setup
        mesh = make_tile_mesh()
        spp = 32
        ref, _ = render(
            scene, cam, film, IndependentSampler(spp), "path", spp=spp,
            max_depth=3, wave_spp=32,
        )
        img, _ = render_sharded(
            scene, cam, film, IndependentSampler(spp), mesh, "path", spp=spp,
            max_depth=3, wave_spp=4, mode="spp",
        )
        # Same total sample set (0..spp-1 split across devices) ⇒ identical.
        np.testing.assert_allclose(
            np.asarray(img), np.asarray(ref), rtol=1e-5, atol=1e-5
        )


def test_sharded_replay_gradient_matches_single_device(setup):
    """Row-band-sharded path-replay value-and-grad equals the one-device
    replay over the whole frame (same sample streams)."""
    import dataclasses

    from shimmer_tpu.parallel.render import (
        init_sharded_film_state,
        make_sharded_replay_renderer,
    )
    from shimmer_tpu.render import (
        full_image_pixels,
        make_replay_wavefront_renderer,
    )

    scene, cam, film = setup
    sampler = IndependentSampler(2)
    idx = jnp.arange(2, dtype=jnp.uint32)
    mesh = make_tile_mesh()
    sharded = make_sharded_replay_renderer(cam, film, sampler, mesh, max_depth=3)
    single = make_replay_wavefront_renderer(scene, cam, film, sampler, max_depth=3)
    pixel_xy = full_image_pixels(film)
    valid = jnp.ones(pixel_xy.shape[0], bool)

    def with_refl(refl):
        mats = dataclasses.replace(scene.materials, reflectance=refl)
        return dataclasses.replace(scene, materials=mats)

    def loss_sharded(refl):
        fs = sharded(with_refl(refl), init_sharded_film_state(film, mesh), idx)
        return jnp.sum(fs.rgb_sum)

    def loss_single(refl):
        fs = single(with_refl(refl), film.init_state(), idx, pixel_xy, valid)
        return jnp.sum(fs.rgb_sum)

    refl = scene.materials.reflectance
    v_s, g_s = jax.jit(jax.value_and_grad(loss_sharded))(refl)
    v_1, g_1 = jax.jit(jax.value_and_grad(loss_single))(refl)
    assert np.abs(np.asarray(g_1)).max() > 0
    np.testing.assert_allclose(float(v_s), float(v_1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_1), rtol=1e-4, atol=1e-6)
