"""Gradient validation: AD pixel-gradients vs central finite differences.

BASELINE.md backward gate: "texture/BSDF pixel-gradients allclose to
finite differences".  The estimator uses common random numbers (the
counter-based sampler's stream depends only on (pixel, sample, dim), never
on scene parameters), so for smooth parameters the *realized* image is a
smooth function of theta and FD-vs-AD agree tightly — far tighter than the
Monte-Carlo noise floor.  Russian roulette's survival probability is
detached inside the integrators (sampling measure, not integrand), so the
only param-dependent discontinuities are measure-zero lobe flips.

Covers (VERDICT round 1, item 4): (a) diffuse reflectance coeffs,
(b) emission scale, (c) conductor roughness, (d) an image-texture texel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shimmer_tpu.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu.color.colorspace import get_named_color_space
from shimmer_tpu.film.filters import BoxFilter, get_camera_sample
from shimmer_tpu.film.film import PixelSensor, RgbFilm
from shimmer_tpu.integrators.path import li_path
from shimmer_tpu.lights import lights as lt
from shimmer_tpu.materials import material as mtl
from shimmer_tpu.ops.transform import Transform
from shimmer_tpu.samplers import IndependentSampler
from shimmer_tpu.scene_builder import build_scene
from shimmer_tpu.spectra.spectrum import ConstantSpectrum


RES = 12
SPP = 32
MAX_DEPTH = 3


def _cam_film():
    cs = get_named_color_space("srgb")
    ct = CameraTransform(
        Transform.look_at(
            jnp.array([0.0, 0.0, -4.0]),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
    )
    cam = PerspectiveCamera(ct, (RES, RES), fov=45.0)
    film = RgbFilm((RES, RES), BoxFilter(), PixelSensor(cs), cs)
    return cam, film


def _mean_radiance(scene, cam, film):
    """Mean of the per-lane radiance estimate over all pixels x SPP,
    at a fixed sampler seed (common random numbers)."""
    sampler = IndependentSampler(SPP, seed=7)
    ys, xs = jnp.meshgrid(
        jnp.arange(RES, dtype=jnp.int32),
        jnp.arange(RES, dtype=jnp.int32),
        indexing="ij",
    )
    pixel_xy = jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)

    def one(sample_index):
        s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
        u_lam, s_state = sampler.get_1d(s_state)
        swl = film.sample_wavelengths(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
        ray = cam.generate_ray(p_film, u_l)
        l = li_path(scene, ray, swl, sampler, s_state, MAX_DEPTH)
        return jnp.mean(l)

    vals = jax.lax.map(one, jnp.arange(SPP, dtype=jnp.uint32))
    return jnp.mean(vals)


def _fd_vs_ad(f, theta0, h, rtol, atol=0.0):
    """Central finite difference of f at theta0 (scalar theta) vs AD."""
    f_jit = jax.jit(f)
    g_ad = float(jax.jit(jax.grad(f))(theta0))
    g_fd = float((f_jit(theta0 + h) - f_jit(theta0 - h)) / (2.0 * h))
    np.testing.assert_allclose(
        g_ad, g_fd, rtol=rtol, atol=atol, err_msg=f"ad={g_ad} fd={g_fd}"
    )
    return g_ad, g_fd


class TestGradients:
    def test_diffuse_reflectance(self):
        """d(mean image)/d(reflectance coeff) — sphere + area light."""
        cam, film = _cam_film()
        scene = build_scene(
            spheres=[
                {"radius": 1.0, "material_id": 0},
                {
                    "radius": 0.3,
                    "material_id": 1,
                    "area_light_id": 0,
                    "object_to_world": Transform.translate(
                        jnp.array([0.0, 2.0, 0.0])
                    ),
                },
            ],
            materials=[
                {"kind": mtl.DIFFUSE, "reflectance": [0.6, 0.5, 0.4]},
                {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
            ],
            lights=[
                {
                    "kind": lt.AREA,
                    "spectrum": ConstantSpectrum(20.0),
                    "shape_kind": 0,
                    "shape_idx": 1,
                }
            ],
            render_from_world=cam.camera_transform.render_from_world(),
        )
        cam_, film_ = cam, film

        def f(theta):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            return _mean_radiance(
                dataclasses.replace(scene, materials=mats), cam_, film_
            )

        theta0 = jnp.float32(scene.materials.reflectance[0, 1])
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=1e-2, rtol=2e-2)
        assert abs(g_ad) > 1e-6, "gradient should be nonzero"

    def test_emission_scale(self):
        """d(mean image)/d(light scale) is exactly linear -> tight match."""
        cam, film = _cam_film()
        scene = build_scene(
            spheres=[
                {"radius": 1.0, "material_id": 0},
                {
                    "radius": 0.3,
                    "material_id": 1,
                    "area_light_id": 0,
                    "object_to_world": Transform.translate(
                        jnp.array([0.0, 2.0, 0.0])
                    ),
                },
            ],
            materials=[
                {"kind": mtl.DIFFUSE, "reflectance": [0.7, 0.7, 0.7]},
                {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
            ],
            lights=[
                {
                    "kind": lt.AREA,
                    "spectrum": ConstantSpectrum(1.0),
                    "scale": 20.0,
                    "shape_kind": 0,
                    "shape_idx": 1,
                }
            ],
            render_from_world=cam.camera_transform.render_from_world(),
        )

        def f(theta):
            lights = dataclasses.replace(
                scene.lights, scale=scene.lights.scale.at[0].set(theta)
            )
            return _mean_radiance(
                dataclasses.replace(scene, lights=lights), cam, film
            )

        theta0 = jnp.float32(scene.lights.scale[0])
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=0.5, rtol=1e-3)
        assert g_ad > 0.0

    def test_conductor_roughness(self):
        """d(mean image)/d(GGX roughness) — rough conductor in a uniform
        environment; gradient flows through VNDF sampling + the BRDF."""
        cam, film = _cam_film()
        cs = get_named_color_space("srgb")
        scene = build_scene(
            spheres=[{"radius": 1.0, "material_id": 0}],
            materials=[
                {
                    "kind": mtl.CONDUCTOR,
                    # stored value is pre-remap roughness; eval applies
                    # alpha = sqrt(stored) (loading/scene_builder.py:753)
                    "uroughness": 0.09,
                    "vroughness": 0.09,
                }
            ],
            lights=[
                {
                    "kind": lt.UNIFORM_INFINITE,
                    "spectrum": cs.illuminant,
                    "photometric": True,
                }
            ],
            render_from_world=cam.camera_transform.render_from_world(),
        )

        def f(theta):
            mats = dataclasses.replace(
                scene.materials,
                uroughness=scene.materials.uroughness.at[0].set(theta),
                vroughness=scene.materials.vroughness.at[0].set(theta),
            )
            return _mean_radiance(
                dataclasses.replace(scene, materials=mats), cam, film
            )

        theta0 = jnp.float32(scene.materials.uroughness[0])
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=1e-2, rtol=5e-2, atol=1e-4)
        assert abs(g_ad) > 1e-6, "roughness gradient should be nonzero"

    def test_texture_texel(self):
        """d(mean image)/d(one atlas texel) — image texture driving the
        diffuse reflectance of the sphere."""
        from shimmer_tpu.textures import textures as tx

        cam, film = _cam_film()
        cs = get_named_color_space("srgb")
        b = tx.TextureBuilder()
        img = np.full((4, 4, 3), 0.5, np.float32)
        tid = b.add_image(
            img, is_spectrum=True, filter_kind=tx.FILTER_POINT
        )
        table = b.build()
        scene = build_scene(
            spheres=[{"radius": 1.0, "material_id": 0}],
            materials=[
                {
                    "kind": mtl.DIFFUSE,
                    "reflectance": [0.5, 0.5, 0.5],
                    "tex_reflectance": tid,
                }
            ],
            lights=[
                {
                    "kind": lt.UNIFORM_INFINITE,
                    "spectrum": cs.illuminant,
                    "photometric": True,
                }
            ],
            textures=table,
            render_from_world=cam.camera_transform.render_from_world(),
        )

        # Perturb one sigmoid-coefficient channel of one texel that the
        # sphere's UV footprint actually covers (under point filtering the
        # footprint covers texels 0-8 and 11; advisor r2 measured texel 5's
        # grad ~5e-5, while texel 9 is never sampled).
        texel = 1 * 4 + 1  # row 1, col 1 of the 4x4 level-0 image
        off = int(scene.textures.level0_offset[tid]) + texel

        def f(theta):
            atlas = scene.textures.atlas.at[off, 2].set(theta)
            texs = dataclasses.replace(scene.textures, atlas=atlas)
            return _mean_radiance(
                dataclasses.replace(scene, textures=texs), cam, film
            )

        theta0 = jnp.float32(scene.textures.atlas[off, 2])
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=5e-3, rtol=5e-2, atol=1e-7)
        assert abs(g_ad) > 0.0, "texel gradient should be nonzero"

        # Whole-atlas variant: shift channel 2 of every level-0 texel of
        # this texture — must be nonzero no matter which texels the UV
        # footprint lands on (VERDICT r2 item 2).
        n_texels = int(np.prod(img.shape[:2]))
        base = int(scene.textures.level0_offset[tid])

        def f_all(theta):
            atlas = scene.textures.atlas.at[base : base + n_texels, 2].add(
                theta
            )
            texs = dataclasses.replace(scene.textures, atlas=atlas)
            return _mean_radiance(
                dataclasses.replace(scene, textures=texs), cam, film
            )

        g_ad, g_fd = _fd_vs_ad(f_all, jnp.float32(0.0), h=5e-3, rtol=5e-2)
        assert abs(g_ad) > 1e-6, "whole-atlas gradient should be nonzero"


class TestProductionScaleGradients:
    """VERDICT r2 item 3: FD-vs-AD at >= 64x64, depth 5, on the BVH8
    triangle scene, with remat (the scan-with-recompute form of
    path-replay backprop) bounding activation memory per bounce."""

    @staticmethod
    def _tri_scene(res=64):
        from shimmer_tpu.shapes.mesh import TriangleMesh, quad_mesh
        from shimmer_tpu.shapes.triangle import build_triangle_scene

        cs = get_named_color_space("srgb")
        ct = CameraTransform(
            Transform.look_at(
                jnp.array([0.0, 0.8, -3.2]),
                jnp.array([0.0, 0.2, 0.0]),
                jnp.array([0.0, 1.0, 0.0]),
            )
        )
        cam = PerspectiveCamera(ct, (res, res), fov=42.0)
        film = RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)
        r2w = cam.camera_transform.render_from_world()

        # Displaced grid mesh (few hundred tris) + floor + light quad.
        m = 10
        ys, xs = np.meshgrid(
            np.linspace(-1, 1, m + 1), np.linspace(-1, 1, m + 1),
            indexing="ij",
        )
        zs = 0.25 * np.sin(2.2 * xs) * np.cos(1.7 * ys)
        verts = np.stack(
            [xs.ravel(), 0.35 * zs.ravel() + 0.2, ys.ravel()], axis=-1
        ).astype(np.float32)
        ii = np.arange(m * m).reshape(m, m)
        ii = (ii // m) * (m + 1) + (ii % m)
        quads = np.stack(
            [ii, ii + 1, ii + m + 2, ii, ii + m + 2, ii + m + 1], axis=-1
        ).reshape(-1, 3).astype(np.int32)
        mesh = TriangleMesh(r2w, quads, verts)
        floor = quad_mesh(
            r2w, [-4, -0.4, -4], [4, -0.4, -4], [4, -0.4, 4], [-4, -0.4, 4]
        )
        lightq = quad_mesh(
            r2w, [-0.7, 2.5, -0.7], [0.7, 2.5, -0.7],
            [0.7, 2.5, 0.7], [-0.7, 2.5, 0.7],
        )
        meshes = [
            mesh.as_scene_dict(0),
            floor.as_scene_dict(1),
            lightq.as_scene_dict(2, area_light_id=np.array([0, 1], np.int32)),
        ]
        tris = build_triangle_scene(meshes)
        n_tri = int(np.asarray(tris.orig_indices).shape[0])
        scene = build_scene(
            triangles=tris,
            materials=[
                {"kind": mtl.DIFFUSE, "reflectance": [0.6, 0.45, 0.35]},
                {"kind": mtl.DIFFUSE, "reflectance": [0.4, 0.4, 0.45]},
                {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
            ],
            lights=[
                {
                    "kind": lt.AREA,
                    "spectrum": ConstantSpectrum(1.0),
                    "scale": 18.0,
                    "shape_kind": 1,
                    "shape_idx": n_tri - 2 + k,
                }
                for k in range(2)
            ],
            render_from_world=r2w,
        )
        return scene, cam, film

    @staticmethod
    def _mean_radiance_big(scene, cam, film, spp=4, max_depth=5,
                           remat=True):
        res = film.resolution[0]
        sampler = IndependentSampler(spp, seed=11)
        ys, xs = jnp.meshgrid(
            jnp.arange(res, dtype=jnp.int32),
            jnp.arange(res, dtype=jnp.int32),
            indexing="ij",
        )
        pixel_xy = jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)

        def one(sample_index):
            s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
            u_lam, s_state = sampler.get_1d(s_state)
            swl = film.sample_wavelengths(u_lam)
            u_f, s_state = sampler.get_pixel_2d(s_state)
            u_l, s_state = sampler.get_2d(s_state)
            p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
            ray = cam.generate_ray(p_film, u_l)
            l = li_path(
                scene, ray, swl, sampler, s_state, max_depth, remat=remat
            )
            return jnp.mean(l)

        vals = jax.lax.map(one, jnp.arange(spp, dtype=jnp.uint32))
        return jnp.mean(vals)

    def test_remat_matches_nonremat(self):
        """remat must not change the forward value or the gradient."""
        scene, cam, film = self._tri_scene()

        def f(theta, remat):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            return self._mean_radiance_big(
                dataclasses.replace(scene, materials=mats), cam, film,
                spp=1, max_depth=3, remat=remat,
            )

        theta0 = jnp.float32(0.45)
        v0, g0 = jax.value_and_grad(lambda t: f(t, False))(theta0)
        v1, g1 = jax.value_and_grad(lambda t: f(t, True))(theta0)
        np.testing.assert_allclose(float(v0), float(v1), rtol=1e-6)
        np.testing.assert_allclose(float(g0), float(g1), rtol=1e-5)

    @pytest.mark.slow
    def test_reflectance_64px_depth5(self):
        """FD-vs-AD at 64x64, depth 5, 4 spp on the triangle scene."""
        scene, cam, film = self._tri_scene()

        def f(theta):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            return self._mean_radiance_big(
                dataclasses.replace(scene, materials=mats), cam, film
            )

        theta0 = jnp.float32(0.45)
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=1e-2, rtol=3e-2)
        assert abs(g_ad) > 1e-6


class TestReplayWavefrontGradients:
    """Path-replay backprop for the production wavefront
    (render.py::make_replay_wavefront_renderer, SURVEY §7 P5): forward
    value == wavefront, gradient == megakernel replay."""

    def _setup(self):
        cam, film = _cam_film()
        scene = build_scene(
            spheres=[
                {"radius": 1.0, "material_id": 0},
                {
                    "radius": 0.3,
                    "material_id": 1,
                    "area_light_id": 0,
                    "object_to_world": Transform.translate(
                        jnp.array([0.0, 2.0, 0.0])
                    ),
                },
            ],
            materials=[
                {"kind": mtl.DIFFUSE, "reflectance": [0.6, 0.5, 0.4]},
                {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
            ],
            lights=[
                {
                    "kind": lt.AREA,
                    "spectrum": ConstantSpectrum(20.0),
                    "shape_kind": 0,
                    "shape_idx": 1,
                }
            ],
            render_from_world=cam.camera_transform.render_from_world(),
        )
        return scene, cam, film

    def test_wavefront_grad_matches_megakernel(self):
        from shimmer_tpu.render import (
            INTEGRATORS,
            full_image_pixels,
            make_replay_wavefront_renderer,
            make_wavefront_renderer,
            render_pixel_samples,
        )

        scene, cam, film = self._setup()
        spp = 2
        sampler = IndependentSampler(spp)
        pixel_xy = full_image_pixels(film)
        valid = jnp.ones(pixel_xy.shape[0], bool)
        idx = jnp.arange(spp, dtype=jnp.uint32)
        max_depth = 3

        replay = make_replay_wavefront_renderer(
            scene, cam, film, sampler, max_depth=max_depth
        )

        def loss_replay(theta):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            sc = dataclasses.replace(scene, materials=mats)
            fs = replay(sc, film.init_state(), idx, pixel_xy, valid)
            return jnp.sum(fs.rgb_sum) / pixel_xy.shape[0]

        def loss_mega(theta):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            sc = dataclasses.replace(scene, materials=mats)
            fs = render_pixel_samples(
                sc, cam, film, sampler, INTEGRATORS["path"], {},
                film.init_state(), idx, pixel_xy, pixel_valid=valid,
                max_depth=max_depth,
            )
            return jnp.sum(fs.rgb_sum) / pixel_xy.shape[0]

        theta0 = jnp.float32(scene.materials.reflectance[0, 1])
        v_r, g_r = jax.jit(jax.value_and_grad(loss_replay))(theta0)
        v_m, g_m = jax.jit(jax.value_and_grad(loss_mega))(theta0)
        # forward value comes from the wavefront
        wf = make_wavefront_renderer(scene, cam, film, sampler, max_depth=max_depth)
        fs_wf = wf(film.init_state(), idx, pixel_xy, valid)
        v_wf = float(jnp.sum(fs_wf.rgb_sum) / pixel_xy.shape[0])
        assert abs(float(v_r) - v_wf) < 1e-5 * max(abs(v_wf), 1.0)
        # same-estimator forward values agree to accumulation order
        np.testing.assert_allclose(float(v_r), float(v_m), rtol=1e-4)
        # the replayed gradient IS the megakernel gradient
        assert abs(float(g_r)) > 1e-7
        np.testing.assert_allclose(float(g_r), float(g_m), rtol=1e-5)

    def test_replay_grad_matches_fd(self):
        """End-to-end: replay gradient vs central finite differences."""
        from shimmer_tpu.render import (
            full_image_pixels,
            make_replay_wavefront_renderer,
        )

        scene, cam, film = self._setup()
        spp = 4
        sampler = IndependentSampler(spp)
        pixel_xy = full_image_pixels(film)
        valid = jnp.ones(pixel_xy.shape[0], bool)
        idx = jnp.arange(spp, dtype=jnp.uint32)
        replay = make_replay_wavefront_renderer(
            scene, cam, film, sampler, max_depth=3
        )

        def f(theta):
            mats = dataclasses.replace(
                scene.materials,
                reflectance=scene.materials.reflectance.at[0, 1].set(theta),
            )
            sc = dataclasses.replace(scene, materials=mats)
            fs = replay(sc, film.init_state(), idx, pixel_xy, valid)
            return jnp.sum(fs.rgb_sum) / pixel_xy.shape[0]

        theta0 = jnp.float32(scene.materials.reflectance[0, 1])
        g_ad, g_fd = _fd_vs_ad(f, theta0, h=1e-2, rtol=5e-2)
        assert abs(g_ad) > 1e-7
