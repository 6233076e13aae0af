"""Device scene: flat SoA tables + static census.

TPU-native replacement for the reference's pointer-linked scene
(Arc-wrapped primitives, /root/reference/src/primitive.rs): geometry,
materials and lights are flat arrays in HBM; the *census* (which material
kinds, light kinds, shape kinds exist) is static host metadata that
specializes the traced program — only code paths for present kinds are
compiled.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.lights.lights import LightData, is_delta_light
from shimmer_tpu.materials.material import MaterialTable
from shimmer_tpu.ops.sampling import sample_discrete
from shimmer_tpu.shapes.sphere import SphereData, sphere_intersect
from shimmer_tpu.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Scene:
    spheres: SphereData | None
    triangles: object | None      # TriangleSceneData (shapes/triangle.py)
    materials: MaterialTable
    lights: LightData
    light_sample_weights: jnp.ndarray  # (L,) pmf weights (uniform or power)
    spectra_table: jnp.ndarray | None  # (K, 471) shared dense spectra (IORs…)
    env: object | None            # EnvLightData (lights/env.py)
    textures: object | None       # TextureTable (textures/textures.py)
    patches: object | None = None  # BilinearPatchData (shapes/bilinear.py)
    instanced: object | None = None  # InstancedTriangles (shapes/instanced.py)
    media: object | None = None    # MediumData (media.py)
    # --- static census ---
    # Medium the camera sits in (index into media; -1 = vacuum).  Static:
    # the megakernel's medium branch compiles only when a medium exists.
    camera_medium: int = static_field(default=-1)
    # Any shape declares a MediumInterface: per-lane medium tracking
    # (megakernel li_path; the wavefront handles exterior media only).
    has_interface_media: bool = static_field(default=False)
    material_kinds: tuple = static_field(default=())
    light_kinds: tuple = static_field(default=())
    n_lights: int = static_field(default=0)
    uniform_infinite_indices: tuple = static_field(default=())
    image_infinite_indices: tuple = static_field(default=())
    has_spheres: bool = static_field(default=False)
    has_triangles: bool = static_field(default=False)
    has_patches: bool = static_field(default=False)
    has_instanced: bool = static_field(default=False)
    has_normal_maps: bool = static_field(default=False)
    has_bump_maps: bool = static_field(default=False)


def scene_intersect(scene: Scene, ray_o, ray_d, t_max, want_any=False):
    """Closest-hit intersection against all scene geometry
    (IntegratorBase::intersect → BvhAggregate::intersect analog).

    want_any: per-lane bool — lanes flagged True terminate at their first
    accepted hit (only ``valid`` is meaningful for them).  This lets a
    path bounce trace its extension rays and its NEE shadow rays in ONE
    traversal dispatch."""
    si = None
    if scene.has_spheres:
        si = sphere_intersect(scene.spheres, ray_o, ray_d, t_max)
    if scene.has_triangles:
        from shimmer_tpu.shapes.triangle import triangle_scene_intersect

        si_t = triangle_scene_intersect(
            scene.triangles, ray_o, ray_d, t_max, want_any=want_any
        )
        si = si_t if si is None else _closer(si, si_t)
    if scene.has_patches:
        from shimmer_tpu.shapes.bilinear import bilinear_intersect

        si_p = bilinear_intersect(scene.patches, ray_o, ray_d, t_max)
        si = si_p if si is None else _closer(si, si_p)
    if scene.has_instanced:
        from shimmer_tpu.shapes.instanced import instanced_intersect

        si_i = instanced_intersect(
            scene.instanced, ray_o, ray_d, t_max, want_any=want_any
        )
        si = si_i if si is None else _closer(si, si_i)
    assert si is not None, "scene has no geometry"
    return si


def scene_intersect_merged(scene: Scene, ray_o, ray_d, t_max, n_ext):
    """Wavefront merged trace: lanes [:n_ext] are extension rays
    (closest-hit, full interaction), lanes [n_ext:] are shadow rays
    (any-hit, only occlusion needed).  Returns (si_ext, occluded).

    For triangles-only scenes this avoids building (and discarding)
    interactions for the shadow half of every dispatch: one raw
    traversal over all lanes, interaction construction only on the
    extension slice.  Mixed-geometry scenes fall back to the general
    union intersect."""
    n_all = ray_o.shape[0]
    want_any = jnp.arange(n_all) >= n_ext
    if (
        scene.has_triangles
        and not (scene.has_spheres or scene.has_patches or scene.has_instanced)
    ):
        from shimmer_tpu.shapes.triangle import (
            _traverse_raw,
            triangle_interaction_from_raw,
        )

        _, tri = _traverse_raw(
            scene.triangles,
            jax.lax.stop_gradient(ray_o),
            jax.lax.stop_gradient(ray_d),
            jax.lax.stop_gradient(t_max),
            any_hit=want_any,
        )
        si = triangle_interaction_from_raw(
            scene.triangles, ray_o[:n_ext], ray_d[:n_ext], tri[:n_ext]
        )
        return si, tri[n_ext:] >= 0
    si_all = scene_intersect(scene, ray_o, ray_d, t_max, want_any=want_any)
    si = type(si_all)(
        **{
            f.name: getattr(si_all, f.name)[:n_ext]
            for f in dataclasses.fields(si_all)
        }
    )
    return si, si_all.valid[n_ext:]


def scene_intersect_merged_full(scene: Scene, ray_o, ray_d, t_max, n_ext):
    """Merged trace where BOTH halves need closest-hit interactions
    (interface-media scenes: the shadow march continues past
    material-less boundary shapes, so shadow lanes need material/medium
    ids, not just an occlusion bit).  Returns (si_ext, si_shadow)."""
    si_all = scene_intersect(scene, ray_o, ray_d, t_max)

    def _slice(lo, hi):
        return type(si_all)(
            **{
                f.name: getattr(si_all, f.name)[lo:hi]
                for f in dataclasses.fields(si_all)
            }
        )

    return _slice(0, n_ext), _slice(n_ext, ray_o.shape[0])


def _closer(a, b):
    take_b = b.valid & (~a.valid | (b.t < a.t))
    merged = {}
    for f in dataclasses.fields(a):
        va = getattr(a, f.name)
        vb = getattr(b, f.name)
        cond = take_b
        if va.ndim > take_b.ndim:
            cond = take_b[..., None]
        merged[f.name] = jnp.where(cond, vb, va)
    return type(a)(**merged)


def scene_intersect_predicate(scene: Scene, ray_o, ray_d, t_max):
    """Any-hit (shadow) test (IntegratorBase::intersect_predicate)."""
    hit = jnp.zeros(ray_o.shape[:-1], bool)
    if scene.has_spheres:
        si = sphere_intersect(scene.spheres, ray_o, ray_d, t_max)
        hit = hit | si.valid
    if scene.has_triangles:
        from shimmer_tpu.shapes.triangle import triangle_scene_occluded

        hit = hit | triangle_scene_occluded(scene.triangles, ray_o, ray_d, t_max)
    if scene.has_patches:
        from shimmer_tpu.shapes.bilinear import bilinear_occluded

        hit = hit | bilinear_occluded(scene.patches, ray_o, ray_d, t_max)
    if scene.has_instanced:
        from shimmer_tpu.shapes.instanced import instanced_occluded

        hit = hit | instanced_occluded(scene.instanced, ray_o, ray_d, t_max)
    return hit


def sample_light(scene: Scene, u):
    """Light sampler: importance-sample the light table
    (UniformLightSampler light_sampler.rs:78-112, or power weights —
    the PowerLightSampler the reference lists as TODO, light_sampler.rs:32).

    Returns (light_idx, pmf, u_remapped)."""
    w = jnp.broadcast_to(
        scene.light_sample_weights, u.shape + (scene.n_lights,)
    )
    return sample_discrete(w, u)


def light_pmf(scene: Scene, light_idx):
    """pmf of having sampled light_idx."""
    total = jnp.sum(scene.light_sample_weights)
    return scene.light_sample_weights[light_idx] / total
