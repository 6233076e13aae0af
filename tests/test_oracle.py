"""Forward-estimator oracle: the production renderer vs an independent
brute-force numpy path tracer on a scene with interreflection.

VERDICT round-1 item 6: the Rust reference cannot build here (no cargo,
.spec tables absent), so the matched-seeds image gate is approximated by
an *independent implementation* comparison: a dumb, trustworthy numpy
megakernel (no BVH, no NEE/MIS, no spectral pipeline — pure cosine-sampled
gray-world path tracing) must agree with the full spectral renderer
on mean radiance within Monte-Carlo tolerance.

Scene: two diffuse spheres (one offset, causing interreflection the
analytic furnace tests cannot see) in a photometric uniform environment.
With gray albedo and a D65 photometric env (pixels resolve to exactly
(1,1,1) — light.rs:599-614 convention), the spectral pipeline's RGB equals
the gray-world scalar radiance.
"""

import dataclasses

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
from shimmer_tpu.render import render
from shimmer_tpu.samplers import IndependentSampler
from shimmer_tpu.scene_builder import build_scene

RES = 24
CENTERS = np.array([[0.0, 0.0, 0.0], [1.1, 0.0, -1.0]], np.float32)
RADII = np.array([1.0, 0.8], np.float32)
ALBEDO = 0.65
CAM_POS = np.array([0.0, 0.0, -4.0], np.float32)
FOV = 45.0
MAX_DEPTH = 8


def _oracle_render(spp=2048, seed=1):
    """Vectorized numpy path tracer: gray world, cosine BSDF sampling
    only (no NEE), uniform env of radiance 1."""
    rng = np.random.default_rng(seed)
    h = w = RES
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w), np.float64)

    tan_half = np.tan(np.radians(FOV) / 2.0)
    for s in range(spp):
        # box filter: jitter inside the pixel
        px = (xs + rng.random((h, w))).reshape(-1)
        py = (ys + rng.random((h, w))).reshape(-1)
        # NDC -> camera ray (matches PerspectiveCamera: fov on the
        # shorter axis; square here so both)
        sx = (2.0 * px / w - 1.0) * tan_half
        sy = (1.0 - 2.0 * py / h) * tan_half
        d = np.stack([sx, sy, np.ones_like(sx)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(CAM_POS, d.shape).copy()

        n_rays = d.shape[0]
        beta = np.ones(n_rays)
        radiance = np.zeros(n_rays)
        alive = np.ones(n_rays, bool)

        for depth in range(MAX_DEPTH + 1):
            # intersect both spheres
            t_best = np.full(n_rays, np.inf)
            hit_i = np.full(n_rays, -1)
            for i in range(len(RADII)):
                oc = o - CENTERS[i]
                b = np.sum(oc * d, -1)
                c = np.sum(oc * oc, -1) - RADII[i] ** 2
                disc = b * b - c
                ok = disc > 0
                sq = np.sqrt(np.where(ok, disc, 0))
                t0 = -b - sq
                t1 = -b + sq
                t = np.where(t0 > 1e-3, t0, np.where(t1 > 1e-3, t1, np.inf))
                closer = ok & (t < t_best)
                t_best = np.where(closer, t, t_best)
                hit_i = np.where(closer, i, hit_i)
            miss = alive & ~np.isfinite(t_best)
            radiance = np.where(miss, radiance + beta, radiance)  # env L=1
            alive = alive & np.isfinite(t_best)
            if depth == MAX_DEPTH or not alive.any():
                break
            p = o + d * np.where(alive, t_best, 0.0)[:, None]
            n_vec = p - CENTERS[np.maximum(hit_i, 0)]
            n_vec /= np.maximum(
                np.linalg.norm(n_vec, axis=-1, keepdims=True), 1e-12
            )
            # cosine-hemisphere sample around n
            u1 = rng.random(n_rays)
            u2 = rng.random(n_rays)
            r = np.sqrt(u1)
            phi = 2 * np.pi * u2
            lx = r * np.cos(phi)
            ly = r * np.sin(phi)
            lz = np.sqrt(np.maximum(0.0, 1.0 - u1))
            # frame around n
            sgn = np.where(n_vec[:, 2] >= 0, 1.0, -1.0)
            a = -1.0 / (sgn + n_vec[:, 2])
            bvec = n_vec[:, 0] * n_vec[:, 1] * a
            t1v = np.stack(
                [
                    1.0 + sgn * n_vec[:, 0] ** 2 * a,
                    sgn * bvec,
                    -sgn * n_vec[:, 0],
                ],
                -1,
            )
            t2v = np.stack(
                [bvec, sgn + n_vec[:, 1] ** 2 * a, -n_vec[:, 1]], -1
            )
            d = (
                lx[:, None] * t1v + ly[:, None] * t2v + lz[:, None] * n_vec
            )
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            o = p + n_vec * 1e-3
            beta = beta * ALBEDO  # cosine-sampled lambertian: f*cos/pdf = rho
        img += radiance.reshape(h, w)
    return img / spp


@pytest.mark.slow
def test_render_matches_numpy_oracle():
    cs = get_named_color_space("srgb")
    ct = CameraTransform(
        Transform.look_at(
            jnp.asarray(CAM_POS),
            jnp.array([0.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
    )
    cam = PerspectiveCamera(ct, (RES, RES), fov=FOV)
    film = RgbFilm((RES, RES), BoxFilter(), PixelSensor(cs), cs)
    scene = build_scene(
        spheres=[
            {
                "radius": float(RADII[i]),
                "material_id": 0,
                "object_to_world": Transform.translate(jnp.asarray(CENTERS[i])),
            }
            for i in range(len(RADII))
        ],
        materials=[
            {"kind": mtl.DIFFUSE, "reflectance": [ALBEDO] * 3},
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
    spp = 512
    image, _ = render(
        scene, cam, film, IndependentSampler(spp, seed=3),
        integrator="path", spp=spp, max_depth=MAX_DEPTH, wave_spp=64,
    )
    img = np.asarray(image)
    assert np.all(np.isfinite(img))

    oracle = _oracle_render(spp=1024)

    # Per-pixel MC σ ≈ 0.3/√spp; compare smoothed images and the mean.
    assert abs(img.mean() - oracle.mean()) < 0.01, (
        img.mean(), oracle.mean())
    # channel balance: gray world -> RGB equal
    ch = img.mean(axis=(0, 1))
    np.testing.assert_allclose(ch, ch.mean(), rtol=0.02)
    # block-averaged comparison (4x4 blocks) within 3 sigma-ish
    blk = img.mean(-1).reshape(6, 4, 6, 4).mean((1, 3))
    blk_o = oracle.reshape(6, 4, 6, 4).mean((1, 3))
    np.testing.assert_allclose(blk, blk_o, atol=0.035)
