"""Render orchestration: the wave loop.

TPU-native analog of /root/reference/src/render.rs +
ImageTileIntegrator::render (src/integrator.rs:119-397).  The reference
tiles the image 8×8 over rayon threads and renders spp in growing waves
(1, 2, 4, …, 64); here one *wave* is a single jitted program evaluating a
fixed number of samples for a pixel block at once — the chip's vector lanes
replace threads, the wave loop replaces the spp loop, and the film update is
a scatter-add instead of locked pixel writes.  Multi-chip sharding wraps the
same wave body in shard_map (shimmer_tpu.parallel.render).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.film.filters import get_camera_sample
from shimmer_tpu.film.film import FilmState, RgbFilm
from shimmer_tpu.integrators.path import li_path, li_random_walk, li_simple_path
from shimmer_tpu.scene import Scene

INTEGRATORS = {
    "path": li_path,
    "simplepath": li_simple_path,
    "randomwalk": li_random_walk,
}


def render_pixel_samples(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    li_fn,
    opts: dict,
    film_state: FilmState,
    sample_indices,
    pixel_xy,
    pixel_valid=None,
    max_depth: int = 5,
    use_visible_wavelengths: bool = True,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
):
    """Core wave body: render every sample index for a pixel block and
    scatter into the film (evaluate_pixel_sample, integrator.rs:326-396).

    pixel_xy: (N, 2) int32; pixel_valid: optional (N,) mask for padded
    lanes (their filter weight is zeroed, so they never contribute).
    disable_*_jitter: the in-scene Option flags (scene.rs:1379-1393) —
    pin the filter / wavelength samples at 0.5.
    """

    def one_sample(fs, sample_index):
        s_state = sampler.start_pixel_sample(pixel_xy, sample_index)
        # Draw order mirrors the reference: wavelengths, filter, lens.
        u_lam, s_state = sampler.get_1d(s_state)
        if disable_wavelength_jitter:
            u_lam = jnp.full_like(u_lam, 0.5)
        if use_visible_wavelengths:
            swl = film.sample_wavelengths(u_lam)
        else:
            from shimmer_tpu.spectra.sampled import SampledWavelengths

            swl = SampledWavelengths.sample_uniform(u_lam)
        u_filter, s_state = sampler.get_pixel_2d(s_state)
        if disable_pixel_jitter:
            u_filter = jnp.full_like(u_filter, 0.5)
        u_lens, s_state = sampler.get_2d(s_state)
        p_film, weight, u_lens = get_camera_sample(
            film.filter, pixel_xy, u_filter, u_lens
        )
        if pixel_valid is not None:
            weight = jnp.where(pixel_valid, weight, 0.0)
        ray = camera.generate_ray(p_film, u_lens)
        l = li_fn(scene, ray, swl, sampler, s_state, max_depth, **opts)
        # NaN/∞ guard (integrator.rs:377-382).
        bad = jnp.any(~jnp.isfinite(l), axis=-1)
        l = jnp.where(bad[..., None], 0.0, l)
        # One sample per DISTINCT block pixel per scan step → the film
        # scatter has unique indices (padded duplicate lanes are routed
        # out of bounds and dropped).
        if pixel_valid is not None:
            w_img, h_img = film.resolution
            scatter_xy = jnp.where(
                pixel_valid[..., None], pixel_xy,
                jnp.array([w_img, h_img], pixel_xy.dtype),
            )
        else:
            scatter_xy = pixel_xy
        fs = film.add_samples(fs, scatter_xy, l, swl, weight, unique=True)
        return fs, None

    film_state, _ = jax.lax.scan(one_sample, film_state, sample_indices)
    return film_state


def full_image_pixels(film: RgbFilm):
    w, h = film.resolution
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.int32),
        jnp.arange(w, dtype=jnp.int32),
        indexing="ij",
    )
    return jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def make_wave_renderer(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    integrator: str = "path",
    max_depth: int = 5,
    regularize: bool = False,
    use_visible_wavelengths: bool = True,
    integrator_options: dict | None = None,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
):
    """Jitted wave function over a pixel block.

    The pixel block is a *traced argument*: one compile serves every block
    of the image and every wave (the program is compiled once at block
    size and reused — the analog of the reference's fixed 8×8 tiles,
    tile.rs:21-104).
    """
    li_fn = INTEGRATORS[integrator]
    opts = dict(integrator_options or {})
    if integrator == "path" and regularize:
        opts["regularize"] = True
    spread = getattr(camera, "pixel_spread", 0.0)
    if spread and "pixel_spread" not in opts:
        # spp-scaled differential shrink (integrator.rs:356-362)
        opts["pixel_spread"] = spread * max(
            0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1))
        )

    # The scene rides as a traced ARGUMENT, not a closure constant:
    # closed-over tables embed in the HLO (multi-hundred-MB programs for
    # Ganesha-scale scenes); as a parameter the tables stay
    # device-resident buffers.
    @jax.jit
    def _wave(scene_arg, film_state, sample_indices, pixel_xy, pixel_valid):
        return render_pixel_samples(
            scene_arg,
            camera,
            film,
            sampler,
            li_fn,
            opts,
            film_state,
            sample_indices,
            pixel_xy,
            pixel_valid=pixel_valid,
            max_depth=max_depth,
            use_visible_wavelengths=use_visible_wavelengths,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )

    def render_samples(
        film_state: FilmState, sample_indices, pixel_xy, pixel_valid
    ):
        return _wave(scene, film_state, sample_indices, pixel_xy, pixel_valid)

    return render_samples


def make_scan_wave_renderer(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    integrator: str = "path",
    max_depth: int = 5,
    regularize: bool = False,
    use_visible_wavelengths: bool = True,
    integrator_options: dict | None = None,
):
    """Whole-wave jitted renderer: scans over pixel blocks *inside* one
    program, so an entire wave (all pixels × a set of sample indices) is a
    single device dispatch.  This amortizes host↔device launch latency —
    the analog of persistent kernels — at the cost of one larger
    compile."""
    li_fn = INTEGRATORS[integrator]
    opts = dict(integrator_options or {})
    if integrator == "path" and regularize:
        opts["regularize"] = True
    spread = getattr(camera, "pixel_spread", 0.0)
    if spread and "pixel_spread" not in opts:
        opts["pixel_spread"] = spread * max(
            0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1))
        )

    def render_wave(film_state: FilmState, sample_indices, blocks, valids):
        def body(fs, xs):
            pixel_xy, pixel_valid = xs
            fs = render_pixel_samples(
                scene, camera, film, sampler, li_fn, opts, fs,
                sample_indices, pixel_xy, pixel_valid=pixel_valid,
                max_depth=max_depth,
                use_visible_wavelengths=use_visible_wavelengths,
            )
            return fs, None

        film_state, _ = jax.lax.scan(body, film_state, (blocks, valids))
        return film_state

    return jax.jit(render_wave)


def make_wavefront_renderer(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    max_depth: int = 5,
    regularize: bool = False,
    use_visible_wavelengths: bool = True,
    with_stats: bool = False,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
):
    """Jitted regenerating-wavefront wave function (the production path;
    see integrators/wavefront.py).  Signature matches make_wave_renderer:
    (film_state, sample_indices, pixel_xy, pixel_valid) -> film_state
    (or (film_state, stats) when with_stats — 'rays' is the exact traced
    ray count of the wave, which replaces any separate counting probe)."""
    from shimmer_tpu.integrators.wavefront import render_wave_wavefront

    spread = getattr(camera, "pixel_spread", 0.0)
    if spread:
        spread = spread * max(
            0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1))
        )

    # Scene as traced argument — see make_wave_renderer's note.
    @jax.jit
    def _wave(scene_arg, film_state, sample_indices, pixel_xy, pixel_valid):
        return render_wave_wavefront(
            scene_arg,
            camera,
            film,
            sampler,
            film_state,
            sample_indices,
            pixel_xy,
            pixel_valid,
            max_depth=max_depth,
            regularize=regularize,
            pixel_spread=spread,
            use_visible_wavelengths=use_visible_wavelengths,
            return_stats=with_stats,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )

    def render_samples(film_state, sample_indices, pixel_xy, pixel_valid):
        return _wave(scene, film_state, sample_indices, pixel_xy, pixel_valid)

    return render_samples


def make_replay_wavefront_renderer(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    max_depth: int = 5,
    regularize: bool = False,
    use_visible_wavelengths: bool = True,
):
    """Differentiable wavefront wave: path-replay backprop (SURVEY §7 P5).

    Forward runs the regenerating-wavefront integrator (fast,
    lax.while_loop — not reverse-differentiable) and stores NO per-bounce
    state: the only residuals are the wave inputs themselves.  Backward
    *replays* every (pixel, sample) path through the reverse-mode
    megakernel (integrators/path.py::li_path with per-bounce remat) —
    the counter-based RNG (ops/rng.py) reproduces every decision from
    (pixel, sample index, dimension) alone, and both integrators draw
    identical sampler streams (tests/test_wavefront.py), so the replayed
    estimator equals the forward one and its VJP is the wave's VJP.

    The returned function has the make_wavefront_renderer signature with
    the scene as a leading traced argument:
    (scene, film_state, sample_indices, pixel_xy, pixel_valid) ->
    film_state, and is differentiable w.r.t. scene (material tables,
    textures, light scales) and film_state."""
    li_fn = INTEGRATORS["path"]
    opts = {"regularize": True} if regularize else {}
    # scan-over-bounces + per-bounce checkpoint: one traced bounce (fast
    # compile) and O(1)-in-depth activation memory for the replay VJP.
    opts["remat"] = True
    spread = getattr(camera, "pixel_spread", 0.0)
    if spread:
        opts["pixel_spread"] = spread * max(
            0.125, 1.0 / np.sqrt(max(sampler.samples_per_pixel, 1))
        )

    from shimmer_tpu.integrators.wavefront import render_wave_wavefront

    def _replay(scene, film_state, sample_indices, pixel_xy, pixel_valid):
        return render_pixel_samples(
            scene, camera, film, sampler, li_fn, opts, film_state,
            sample_indices, pixel_xy, pixel_valid=pixel_valid,
            max_depth=max_depth,
            use_visible_wavelengths=use_visible_wavelengths,
        )

    @jax.custom_vjp
    def wave(scene, film_state, sample_indices, pixel_xy, pixel_valid):
        return render_wave_wavefront(
            scene, camera, film, sampler, film_state, sample_indices,
            pixel_xy, pixel_valid, max_depth=max_depth,
            regularize=regularize, pixel_spread=opts.get("pixel_spread", 0.0),
            use_visible_wavelengths=use_visible_wavelengths,
        )

    def fwd(scene, film_state, sample_indices, pixel_xy, pixel_valid):
        out = wave(scene, film_state, sample_indices, pixel_xy, pixel_valid)
        # Residuals = the wave inputs only (per-lane seeds are implicit in
        # pixel ids + sample indices); nothing per-bounce is stored.
        return out, (scene, film_state, sample_indices, pixel_xy, pixel_valid)

    def bwd(res, g):
        _, vjp_fn = jax.vjp(_replay, *res)
        return vjp_fn(g)

    wave.defvjp(fwd, bwd)
    return wave


# Lanes per wavefront dispatch.  The sweep 2^15..2^18 at wave_spp 16 on the
# production frame (H100 80GB HBM3, 700 W) was fastest at 2^18; see PERF.md.
DEFAULT_PIXEL_BLOCK = 1 << 18


def pixel_blocks(film: RgbFilm, block: int):
    """Split the image into fixed-size pixel blocks (+ validity masks)."""
    import numpy as np

    w, h = film.resolution
    n = w * h
    block = min(block, n)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.int32)
    pad = (-n) % block
    if pad:
        px = np.concatenate([px, np.zeros((pad, 2), np.int32)])
    valid = np.ones(n + pad, bool)
    if pad:
        valid[n:] = False
    n_blocks = (n + pad) // block
    return (
        jnp.asarray(px.reshape(n_blocks, block, 2)),
        jnp.asarray(valid.reshape(n_blocks, block)),
    )


def render(
    scene: Scene,
    camera,
    film: RgbFilm,
    sampler,
    integrator: str = "path",
    spp: int | None = None,
    max_depth: int = 5,
    wave_spp: int = 4,
    regularize: bool = False,
    integrator_options: dict | None = None,
    film_state: FilmState | None = None,
    progress=None,
    pixel_block: int = DEFAULT_PIXEL_BLOCK,
    disable_pixel_jitter: bool = False,
    disable_wavelength_jitter: bool = False,
    wavefront: bool | None = None,
    collect_stats: bool = False,
    checkpoint_path=None,
    checkpoint_every: int = 1,
):
    """Full render: wave × pixel-block loop on host, ONE jitted program.

    Returns the resolved (H, W, 3) image and the final FilmState.  The
    FilmState after any wave is a checkpoint: pass it back as
    ``film_state`` to resume, or give ``checkpoint_path`` to persist it
    to disk every ``checkpoint_every`` waves and auto-resume from a
    matching checkpoint on restart — bit-identical to an uninterrupted
    run, since the counter-based sampler needs no RNG state
    (utils/checkpoint.py; the aux subsystem SURVEY.md §5 prescribes).

    wavefront: None (default) uses the regenerating-wavefront integrator
    whenever the estimator is the full path integrator — it is the
    production path (4-10x fewer traversal dispatches); pass False to
    force the masked megakernel (the reverse-differentiable path)."""
    spp = spp if spp is not None else sampler.samples_per_pixel
    use_wavefront = (
        integrator == "path" and not integrator_options
        if wavefront is None
        else wavefront
    )
    if use_wavefront:
        wf_raw = make_wavefront_renderer(
            scene,
            camera,
            film,
            sampler,
            max_depth=max_depth,
            regularize=regularize,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
            with_stats=collect_stats,
        )
        if collect_stats:
            from shimmer_tpu.utils import stats

            def wave_fn(state, idx, px, valid):
                fs, st = wf_raw(state, idx, px, valid)
                stats.counter("Integrator/Rays traced").add(st["rays"])
                stats.counter("Integrator/Wavefront iterations").add(
                    st["iters"]
                )
                return fs

        else:
            wave_fn = wf_raw
    else:
        wave_fn = make_wave_renderer(
            scene,
            camera,
            film,
            sampler,
            integrator,
            max_depth,
            regularize,
            integrator_options=integrator_options,
            disable_pixel_jitter=disable_pixel_jitter,
            disable_wavelength_jitter=disable_wavelength_jitter,
        )
    state = film_state if film_state is not None else film.init_state()
    blocks, valids = pixel_blocks(film, pixel_block)
    n_blocks = blocks.shape[0]
    start = 0
    ckpt = None
    if checkpoint_path is not None:
        from shimmer_tpu.utils.checkpoint import RenderCheckpointer

        ckpt = RenderCheckpointer(
            checkpoint_path,
            fingerprint={
                "resolution": tuple(int(r) for r in film.resolution),
                "spp": int(spp),
                "max_depth": int(max_depth),
                "integrator": integrator,
                "wavefront": bool(use_wavefront),
                "seed": int(getattr(sampler, "seed", 0)),
                "wave_spp": int(wave_spp),
            },
        )
        loaded = ckpt.load()
        if loaded is not None:
            arrays, start = loaded
            state = type(state)(
                rgb_sum=jnp.asarray(arrays["rgb_sum"]),
                weight_sum=jnp.asarray(arrays["weight_sum"]),
                rgb_splat=jnp.asarray(arrays["rgb_splat"]),
            )
    if collect_stats:
        from shimmer_tpu.utils import stats

        stats.counter("Render/Pixel samples").add(film.resolution[0] * film.resolution[1] * spp)
        wave_timer = stats.timer("Render/Wave time")
    while start < spp:
        n = min(wave_spp, spp - start)
        idx = jnp.arange(start, start + n, dtype=jnp.uint32)
        for b in range(n_blocks):
            if collect_stats:
                with wave_timer:
                    state = wave_fn(state, idx, blocks[b], valids[b])
                    jax.block_until_ready(state)
            else:
                state = wave_fn(state, idx, blocks[b], valids[b])
        start += n
        if ckpt is not None and (
            (start // max(wave_spp, 1)) % max(checkpoint_every, 1) == 0
            or start >= spp
        ):
            jax.block_until_ready(state)
            ckpt.save(state, start)
        if progress is not None:
            progress(start, spp)
    image = film.get_image(state)
    return image, state
