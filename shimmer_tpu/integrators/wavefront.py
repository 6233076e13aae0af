"""Wavefront path tracer with ray regeneration — the production render
loop.

The reference plans but never implements a wavefront integrator
(/root/reference/src/main.rs:152-155 ``--wavefront`` todo!,
src/material.rs:1354-1360); SURVEY.md §7 names it the core architecture.
This module is that design.  BVH traversal is the hot path, and a masked
megakernel (integrators/path.py::li_path) runs ``spp x (max_depth+1)``
full-width traversals even though the average path dies after ~1-2
bounces — most of its lanes are dead.

Here a fixed pool of N lanes is kept full: each outer iteration

1. traces ONE merged dispatch — every lane's extension ray (closest-hit)
   and every lane's pending NEE shadow ray (any-hit) as 2N lanes;
2. resolves the shadow contribution, adds MIS-weighted emission for hits
   and escapes, and shades (NEE prepare + BSDF sample + Russian
   roulette), exactly mirroring li_path's estimator and *sampler
   dimension order* — images agree with li_path up to accumulation
   order;
3. scatter-adds finished paths into the film;
4. regenerates free lanes with fresh camera rays pulled from the
   (pixel, sample) work pool via a prefix-sum ticket.

Sequential traversal dispatches per wave drop from
``spp * (depth+1) * 2`` to ``~spp * avg_path_length``, a 4-10x win on
typical scenes.  The loop is a lax.while_loop and therefore not
reverse-differentiable; the differentiable path keeps li_path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from shimmer_tpu.film.filters import get_camera_sample
from shimmer_tpu.integrators.path import (
    INF,
    _apply_dispersion,
    _area_le_with_mis,
    _bsdf_ctx,
    _infinite_le_with_mis,
    _prepare_hit,
    _resolve_mix,
    _with_rng_key,
    sample_ld_prepare,
)
from shimmer_tpu.materials.material import bsdf_pdf, bsdf_sample
from shimmer_tpu.ops.ray import offset_ray_origin
from shimmer_tpu.ops.vecmath import abs_dot, dot
from shimmer_tpu.samplers import SamplerState
from shimmer_tpu.scene import Scene, scene_intersect_merged
from shimmer_tpu.spectra.sampled import SampledWavelengths, ss_is_black
from shimmer_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class _WaveState:
    # lane occupancy
    busy: jnp.ndarray        # (N,) bool — lane carries an in-flight path
    alive: jnp.ndarray       # (N,) bool — extension ray pending
    pend_sh: jnp.ndarray     # (N,) bool — shadow ray pending
    depth: jnp.ndarray       # (N,) int32 — bounces shaded so far
    # rays
    ray_o: jnp.ndarray       # (N, 3)
    ray_d: jnp.ndarray       # (N, 3)
    sh_o: jnp.ndarray        # (N, 3)
    sh_d: jnp.ndarray        # (N, 3)
    sh_tmax: jnp.ndarray     # (N,)
    ld: jnp.ndarray          # (N, 4) pending NEE contribution (beta-scaled)
    # path integrator state (mirrors li_path)
    l: jnp.ndarray           # (N, 4)
    beta: jnp.ndarray        # (N, 4)
    p_b: jnp.ndarray         # (N,)
    eta_scale: jnp.ndarray   # (N,)
    specular: jnp.ndarray    # (N,) bool
    any_ns: jnp.ndarray      # (N,) bool
    prev_p: jnp.ndarray      # (N, 3)
    prev_ns: jnp.ndarray     # (N, 3)
    # per-path bookkeeping
    lam: jnp.ndarray         # (N, 4)
    lam_pdf: jnp.ndarray     # (N, 4)
    lam_term: jnp.ndarray    # (N,) bool — dispersion hero-collapse applied
    s_ph: jnp.ndarray        # (N,) uint32 sampler pixel hash / morton
    s_si: jnp.ndarray        # (N,) uint32 sampler sample index
    s_dim: jnp.ndarray       # (N,) uint32 sampler dimension
    pixel_xy: jnp.ndarray    # (N, 2) int32
    weight: jnp.ndarray      # (N,) filter weight
    item: jnp.ndarray        # (N,) int32 — pool item a lane is working on
    cur_med: jnp.ndarray     # (N,) int32 — lane's current medium (-1 vac)
    sh_med: jnp.ndarray      # (N,) int32 — medium at the shadow origin
    # pool + per-item output + stats.  Finished paths scatter-SET their
    # converted rgb into out_rgb[item] — each pool item retires exactly
    # once, so the scatter has unique indices and no read-modify-write,
    # and its result does not depend on the order of the writes.  The film
    # sees ONE dense reduction + one n-lane scatter-add per wave (see
    # render_wave_wavefront tail).
    pool_next: jnp.ndarray   # () int32
    out_rgb: jnp.ndarray     # (pool, 3) f32
    out_w: jnp.ndarray       # (pool,) f32
    rays: jnp.ndarray        # () f32
    iters: jnp.ndarray       # () f32 — outer while iterations (stats)


def _where_merge(cond, new, old):
    c = cond
    if new.ndim > cond.ndim:
        c = cond.reshape(cond.shape + (1,) * (new.ndim - cond.ndim))
    return jnp.where(c, new, old)


def render_wave_wavefront(
    scene: Scene,
    camera,
    film,
    sampler,
    film_state,
    sample_indices,
    pixel_xy,
    pixel_valid,
    max_depth: int = 5,
    regularize: bool = False,
    pixel_spread: float = 0.0,
    use_visible_wavelengths: bool = True,
    return_stats: bool = False,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
):
    """Render every (pixel in block) x (sample index) pair with a
    regenerating wavefront.  Returns the updated FilmState (and a stats
    dict when return_stats)."""
    n = pixel_xy.shape[0]
    n_samples = int(sample_indices.shape[0])
    pool_total = n * n_samples
    sample_indices = jnp.asarray(sample_indices, jnp.uint32)
    pixel_valid = (
        jnp.ones(n, bool) if pixel_valid is None else jnp.asarray(pixel_valid)
    )

    def regen(st: _WaveState, all_free: bool = False) -> _WaveState:
        free = ~st.busy
        navail = pool_total - st.pool_next
        if all_free:
            # The first fill: every lane is free, so the prefix sum is the
            # lane index.  Spelling it out keeps a constant cumsum out of
            # the program, which XLA's SPMD pipeline would constant-fold
            # as an O(n^2) reduce-window (a compile that never ends at
            # 230,400 lanes per device).
            rank = jnp.arange(n, dtype=jnp.int32)
        else:
            rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        take = free & (rank < navail)
        item = jnp.clip(st.pool_next + rank, 0, pool_total - 1)
        p_idx = item % n
        s_idx = item // n
        px = pixel_xy[p_idx]                       # (N, 2)
        samp = sample_indices[s_idx]               # (N,)
        valid = pixel_valid[p_idx]

        s_state = sampler.start_pixel_sample(px, samp)
        u_lam, s_state = sampler.get_1d(s_state)
        if disable_wavelength_jitter:
            u_lam = jnp.full_like(u_lam, 0.5)
        if use_visible_wavelengths:
            swl = film.sample_wavelengths(u_lam)
        else:
            swl = SampledWavelengths.sample_uniform(u_lam)
        u_f, s_state = sampler.get_pixel_2d(s_state)
        if disable_pixel_jitter:
            u_f = jnp.full_like(u_f, 0.5)
        u_l, s_state = sampler.get_2d(s_state)
        p_film, w, u_l = get_camera_sample(film.filter, px, u_f, u_l)
        ray = camera.generate_ray(p_film, u_l)

        m = lambda new, old: _where_merge(take, new, old)
        zero3 = jnp.zeros((n, 3), jnp.float32)
        return dataclasses.replace(
            st,
            busy=st.busy | take,
            alive=jnp.where(take, valid, st.alive),
            pend_sh=jnp.where(take, False, st.pend_sh),
            depth=m(jnp.zeros(n, jnp.int32), st.depth),
            ray_o=m(ray.o, st.ray_o),
            ray_d=m(ray.d, st.ray_d),
            ld=m(jnp.zeros((n, 4)), st.ld),
            l=m(jnp.zeros((n, 4)), st.l),
            beta=m(jnp.ones((n, 4)), st.beta),
            p_b=m(jnp.ones(n), st.p_b),
            eta_scale=m(jnp.ones(n), st.eta_scale),
            specular=st.specular | take,
            any_ns=jnp.where(take, False, st.any_ns),
            prev_p=m(ray.o, st.prev_p),
            prev_ns=m(zero3, st.prev_ns),
            lam=m(swl.lam, st.lam),
            lam_pdf=m(swl.pdf, st.lam_pdf),
            lam_term=jnp.where(take, False, st.lam_term),
            s_ph=m(s_state.pixel_hash, st.s_ph),
            s_si=m(s_state.sample_index, st.s_si),
            s_dim=m(s_state.dim, st.s_dim),
            pixel_xy=m(px.astype(jnp.int32), st.pixel_xy),
            weight=m(jnp.where(valid, w, 0.0), st.weight),
            item=m(item.astype(jnp.int32), st.item),
            cur_med=m(
                jnp.full(n, scene.camera_medium, jnp.int32), st.cur_med
            ),
            sh_med=m(
                jnp.full(n, scene.camera_medium, jnp.int32), st.sh_med
            ),
            pool_next=st.pool_next
            + jnp.minimum(jnp.sum(free.astype(jnp.int32)), navail),
        )

    iface_med = scene.media is not None and scene.has_interface_media
    has_med = scene.media is not None and (
        scene.camera_medium >= 0 or iface_med
    )

    def body(st: _WaveState) -> _WaveState:
        swl = SampledWavelengths(lam=st.lam, pdf=st.lam_pdf)
        s_state = SamplerState(
            pixel_hash=st.s_ph, sample_index=st.s_si, dim=st.s_dim
        )

        # --- 1. merged trace: extension (closest) + shadow (any-hit) ---
        rays = st.rays + jnp.sum(st.alive.astype(jnp.float32)) + jnp.sum(
            st.pend_sh.astype(jnp.float32)
        )
        mo = jnp.concatenate([st.ray_o, st.sh_o], axis=0)
        md = jnp.concatenate([st.ray_d, st.sh_d], axis=0)
        mt = jnp.concatenate(
            [
                jnp.where(st.alive, INF, -INF),
                jnp.where(st.pend_sh, st.sh_tmax, -INF),
            ],
            axis=0,
        )
        if iface_med:
            from shimmer_tpu.integrators.path import (
                shadow_march_interfaces,
            )
            from shimmer_tpu.scene import scene_intersect_merged_full

            si, si_sh = scene_intersect_merged_full(scene, mo, md, mt, n)
            visible, tr_sh = shadow_march_interfaces(
                scene, swl, st.sh_o, st.sh_d, st.sh_tmax,
                st.pend_sh, st.sh_med, si0=si_sh,
            )
            shadow_add = jnp.where(visible[..., None], st.ld * tr_sh, 0.0)
        else:
            si, occluded = scene_intersect_merged(scene, mo, md, mt, n)
            shadow_add = jnp.where(
                (st.pend_sh & ~occluded)[..., None], st.ld, 0.0
            )

        # --- 2. shadow resolution + emission + shading ---
        l = st.l + shadow_add
        alive = st.alive
        beta_st = st.beta
        scattered = None
        if has_med:
            # Homogeneous-medium distance sampling over the traced
            # segment — the SAME helper as li_path (in-loop and final
            # segment), so estimator and draw order match exactly.
            from shimmer_tpu.integrators.path import _medium_segment

            mid = st.cur_med if iface_med else jnp.full(
                n, scene.camera_medium, jnp.int32
            )
            s_state, beta_st, scattered, (sig_t, g_m, t_m) = (
                _medium_segment(
                    scene, sampler, swl, s_state, mid, si, alive, beta_st
                )
            )
        st = dataclasses.replace(st, beta=beta_st)

        reach = alive if scattered is None else (alive & ~scattered)
        miss = reach & ~si.valid
        l = _infinite_le_with_mis(
            scene, st.ray_d, swl, st.beta, st.p_b, st.specular,
            st.prev_p, st.prev_ns, l, miss,
        )
        l = _area_le_with_mis(
            scene, si, swl, st.beta, st.p_b, st.specular,
            st.prev_p, st.prev_ns, l, reach,
        )
        alive = alive & (
            si.valid if scattered is None else (si.valid | scattered)
        )
        will_shade = alive & (st.depth < max_depth)
        surf_shade = (
            will_shade
            if scattered is None
            else (will_shade & si.valid & ~scattered)
        )
        med_shade = (
            None if scattered is None else (will_shade & scattered)
        )

        si = _prepare_hit(scene, si, st.ray_d, pixel_spread)
        si, s_state = _resolve_mix(scene, si, sampler, s_state)
        beta0, lam_term = _apply_dispersion(
            scene, si, surf_shade, st.beta, st.lam_term
        )
        st = dataclasses.replace(st, beta=beta0)
        frame = si.shading_frame()
        bsdf_ctx = _bsdf_ctx(scene, si, swl)
        bsdf_ctx = _with_rng_key(scene, bsdf_ctx, s_state)
        if regularize:
            bsdf_ctx = dict(bsdf_ctx)
            bsdf_ctx["tex"] = dict(bsdf_ctx.get("tex") or {})
            bsdf_ctx["tex"]["regularize"] = st.any_ns

        beta_nee = st.beta
        ld_new, (sh_o, sh_d, sh_tmax, sh_usable), s_state = sample_ld_prepare(
            scene, si, frame, swl, sampler, s_state, bsdf_ctx
        )
        pend_sh = surf_shade & sh_usable

        u2, s_state = sampler.get_2d(s_state)
        uc, s_state = sampler.get_1d(s_state)
        bs = bsdf_sample(
            scene.materials, scene.material_kinds, si.material_id,
            frame, si.ns, si.wo, u2, uc, swl, **bsdf_ctx,
        )
        cos_f = abs_dot(bs.wi, si.ns)
        step = jnp.where(
            (bs.pdf > 0.0)[..., None],
            bs.f * (cos_f / jnp.maximum(bs.pdf, 1e-20))[..., None],
            0.0,
        )
        beta = jnp.where(surf_shade[..., None], st.beta * step, st.beta)
        from shimmer_tpu.integrators.path import _has_proportional_pdfs

        if not _has_proportional_pdfs(scene):
            p_b_new = bs.pdf
        else:
            p_b_new = jnp.where(
                bs.pdf_is_proportional,
                bsdf_pdf(
                    scene.materials, scene.material_kinds, si.material_id,
                    frame, si.ns, si.wo, bs.wi, swl, **bsdf_ctx,
                ),
                bs.pdf,
            )
        p_b = jnp.where(surf_shade, p_b_new, st.p_b)
        specular = jnp.where(surf_shade, bs.is_specular(), st.specular)
        any_ns = st.any_ns | (surf_shade & ~bs.is_specular())
        eta_scale = jnp.where(
            surf_shade, st.eta_scale * bs.eta * bs.eta, st.eta_scale
        )
        prev_p = _where_merge(surf_shade, si.p, st.prev_p)
        prev_ns = _where_merge(surf_shade, si.ns, st.prev_ns)
        new_o = offset_ray_origin(si.p, si.n, bs.wi)
        ray_o = _where_merge(surf_shade, new_o, st.ray_o)
        ray_d = _where_merge(surf_shade, bs.wi, st.ray_d)
        alive = surf_shade & bs.valid & ~ss_is_black(beta)

        if has_med:
            # --- medium-vertex shading (mirrors li_path's branch) ---
            from shimmer_tpu.integrators.path import (
                sample_ld_medium_prepare,
            )
            from shimmer_tpu.materials.scattering import (
                sample_henyey_greenstein,
            )
            from shimmer_tpu.ops.vecmath import length as _length

            p_med = st.ray_o + t_m[..., None] * st.ray_d
            wo_m = -st.ray_d
            ld_med, (sh_o_m, sh_d_m, sh_tmax_m, usable_m), s_state = (
                sample_ld_medium_prepare(
                    scene, p_med, wo_m, g_m, swl, sampler, s_state
                )
            )
            u2_m, s_state = sampler.get_2d(s_state)
            wi_m, pdf_ph = sample_henyey_greenstein(wo_m, g_m, u2_m)
            scat3 = med_shade[..., None]
            ld_new = jnp.where(scat3, ld_med, ld_new)
            sh_o = jnp.where(scat3, sh_o_m, sh_o)
            sh_d = jnp.where(scat3, sh_d_m, sh_d)
            sh_tmax = jnp.where(med_shade, sh_tmax_m, sh_tmax)
            pend_sh = pend_sh | (med_shade & usable_m)
            if not iface_med:
                # Exact for a single exterior medium; interface scenes
                # use the shadow march's per-sub-segment transmittance.
                ld_new = ld_new * jnp.exp(
                    -sig_t * _length(sh_d)[..., None]
                )
            p_b = jnp.where(med_shade, pdf_ph, p_b)
            specular = jnp.where(med_shade, False, specular)
            any_ns = any_ns | med_shade
            prev_p = _where_merge(med_shade, p_med, prev_p)
            prev_ns = jnp.where(scat3, 0.0, prev_ns)
            ray_o = _where_merge(med_shade, p_med, ray_o)
            ray_d = _where_merge(med_shade, wi_m, ray_d)
            alive = alive | (
                med_shade & (pdf_ph > 0.0) & ~ss_is_black(beta)
            )

        cur_med = st.cur_med
        sh_med = st.sh_med
        if iface_med:
            # --- MediumInterface crossing + material-less pass-through
            # (mirrors integrators/path.py) ---
            declared = si.med_in > -2
            pass_thru = surf_shade & (si.material_id < 0)
            dirn = -si.wo
            pt3 = pass_thru[..., None]
            ray_o = jnp.where(
                pt3, offset_ray_origin(si.p, si.n, dirn), ray_o
            )
            ray_d = jnp.where(pt3, dirn, ray_d)
            beta = jnp.where(pt3, beta_nee, beta)
            p_b = jnp.where(pass_thru, st.p_b, p_b)
            specular = jnp.where(pass_thru, st.specular, specular)
            prev_p = jnp.where(pt3, st.prev_p, prev_p)
            prev_ns = jnp.where(pt3, st.prev_ns, prev_ns)
            pend_sh = pend_sh & ~pass_thru
            alive = alive | pass_thru
            # Medium at the new shadow-ray origin (see li_path).
            sh_side = jnp.where(
                dot(sh_d, si.n) < 0.0, si.med_in, si.med_out
            )
            sh_med = jnp.where(
                surf_shade & declared,
                jnp.maximum(sh_side, -1),
                cur_med,
            )
            crossed = surf_shade & declared & alive
            entering = dot(ray_d, si.n) < 0.0
            new_med = jnp.where(entering, si.med_in, si.med_out)
            cur_med = jnp.where(
                crossed, jnp.maximum(new_med, -1), cur_med
            )

        # Russian roulette on beta * eta_scale (integrator.rs:877-891),
        # applied past the first bounce (per-lane depth here).
        u_rr, s_state = sampler.get_1d(s_state)
        past_first = will_shade & (st.depth > 0)
        rr_beta = jnp.max(beta * eta_scale[..., None], axis=-1)
        # Detached survival probability — see li_path's RR note.
        q = jax.lax.stop_gradient(jnp.maximum(0.0, 1.0 - rr_beta))
        kill = past_first & alive & (u_rr < q)
        beta = jnp.where(
            (past_first & alive)[..., None],
            beta / jnp.maximum(1.0 - q, 1e-6)[..., None],
            beta,
        )
        alive = alive & ~kill
        depth = st.depth + will_shade.astype(jnp.int32)

        # --- 3. film scatter for completed paths ---
        done = st.busy & ~alive & ~pend_sh
        fw = jnp.where(done, st.weight, 0.0)
        # Unique-index scatter-SET into the per-item output: non-done
        # lanes are routed out of bounds and dropped, so there is no
        # read-modify-write and no duplicate-index serialization.
        rgb = film._clamped_rgb(l, swl) * fw[..., None]
        slot = jnp.where(done, st.item, pool_total)
        out_rgb = st.out_rgb.at[slot].set(rgb, mode="drop", unique_indices=True)
        out_w = st.out_w.at[slot].set(fw, mode="drop", unique_indices=True)
        busy = st.busy & ~done

        st = dataclasses.replace(
            st,
            busy=busy, alive=alive, pend_sh=pend_sh, depth=depth,
            ray_o=ray_o, ray_d=ray_d,
            sh_o=_where_merge(pend_sh, sh_o, st.sh_o),
            sh_d=_where_merge(pend_sh, sh_d, st.sh_d),
            sh_tmax=jnp.where(pend_sh, sh_tmax, st.sh_tmax),
            ld=_where_merge(pend_sh, beta_nee * ld_new, st.ld),
            l=l, beta=beta, p_b=p_b, eta_scale=eta_scale,
            specular=specular, any_ns=any_ns, lam_term=lam_term,
            cur_med=cur_med,
            sh_med=jnp.where(pend_sh, sh_med, st.sh_med),
            prev_p=prev_p, prev_ns=prev_ns,
            s_ph=s_state.pixel_hash, s_si=s_state.sample_index,
            s_dim=s_state.dim,
            out_rgb=out_rgb, out_w=out_w, rays=rays,
            iters=st.iters + 1.0,
        )
        # --- 4. regenerate free lanes ---
        return regen(st)

    def cond(st: _WaveState) -> jnp.ndarray:
        return jnp.any(st.busy)

    zero3 = jnp.zeros((n, 3), jnp.float32)
    zero4 = jnp.zeros((n, 4), jnp.float32)
    st0 = _WaveState(
        busy=jnp.zeros(n, bool),
        alive=jnp.zeros(n, bool),
        pend_sh=jnp.zeros(n, bool),
        depth=jnp.zeros(n, jnp.int32),
        ray_o=zero3,
        ray_d=jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], jnp.float32), (n, 3)
        ),
        sh_o=zero3,
        sh_d=jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), (n, 3)),
        sh_tmax=jnp.ones(n, jnp.float32),
        ld=zero4,
        l=zero4,
        beta=jnp.ones((n, 4), jnp.float32),
        p_b=jnp.ones(n, jnp.float32),
        eta_scale=jnp.ones(n, jnp.float32),
        specular=jnp.ones(n, bool),
        any_ns=jnp.zeros(n, bool),
        prev_p=zero3,
        prev_ns=zero3,
        lam=jnp.full((n, 4), 550.0, jnp.float32),
        lam_pdf=jnp.ones((n, 4), jnp.float32),
        lam_term=jnp.zeros(n, bool),
        s_ph=jnp.zeros(n, jnp.uint32),
        s_si=jnp.zeros(n, jnp.uint32),
        s_dim=jnp.zeros(n, jnp.uint32),
        pixel_xy=jnp.zeros((n, 2), jnp.int32),
        weight=jnp.zeros(n, jnp.float32),
        item=jnp.zeros(n, jnp.int32),
        cur_med=jnp.full(n, scene.camera_medium, jnp.int32),
        sh_med=jnp.full(n, scene.camera_medium, jnp.int32),
        pool_next=jnp.zeros((), jnp.int32),
        out_rgb=jnp.zeros((pool_total, 3), jnp.float32),
        out_w=jnp.zeros(pool_total, jnp.float32),
        rays=jnp.zeros((), jnp.float32),
        iters=jnp.zeros((), jnp.float32),
    )
    st0 = regen(st0, all_free=True)
    st = jax.lax.while_loop(cond, body, st0)
    # One dense per-pixel reduction over the sample axis, then a single
    # n-lane scatter-add into the film shard (item = s_idx * n + p_idx).
    per_px_rgb = st.out_rgb.reshape(n_samples, n, 3).sum(0)
    per_px_w = st.out_w.reshape(n_samples, n).sum(0)
    # Sharded renders hand a film view whose scatter space is shard-local
    # (parallel/render.py LocalBandFilm.local_xy).
    scatter_xy = (
        film.local_xy(pixel_xy) if hasattr(film, "local_xy") else pixel_xy
    )
    px = scatter_xy[..., 0]
    py = scatter_xy[..., 1]
    fs = type(film_state)(
        rgb_sum=film_state.rgb_sum.at[py, px].add(
            per_px_rgb.astype(film_state.rgb_sum.dtype)
        ),
        weight_sum=film_state.weight_sum.at[py, px].add(
            per_px_w.astype(film_state.weight_sum.dtype)
        ),
        rgb_splat=film_state.rgb_splat,
    )
    if return_stats:
        return fs, {"rays": st.rays, "iters": st.iters}
    return fs
