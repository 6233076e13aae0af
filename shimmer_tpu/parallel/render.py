"""Multi-device rendering: tile/spp sharding over a device mesh.

Replacement for the reference's rayon tile parallelism
(/root/reference/src/integrator.rs:235-304) and the distributed layer the
reference lacks (SURVEY.md §2 parallelism table): pixel *rows* are sharded
across devices with ``shard_map`` over a ("tiles",) mesh — each device owns
a contiguous row band of the film, renders only its pixels, and
scatter-adds into its film shard.  No collectives run inside a wave (rays are
independent); the only communication is the implicit all-gather when the
sharded film is resolved to an image — the analog of the reference's
lock-free disjoint-tile writes, made safe by construction.

spp sharding (``axis='spp'``) instead gives every device the full image
with a sample-index offset and psums film states at wave end.

The scene is a replicated ARGUMENT of the sharded program, not a closure
constant, so its tables (a 39 MB node table for the 327k-triangle bench
scene) stay device buffers instead of being embedded in the program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shimmer_tpu.film.film import FilmState, RgbFilm
from shimmer_tpu.render import (
    INTEGRATORS,
    make_replay_wavefront_renderer,
    render_pixel_samples,
)


def make_tile_mesh(devices=None, axis: str = "tiles") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def band_pixels(axis: str, rows_per: int, w: int):
    """Global pixel coords of this device's row band."""
    band = jax.lax.axis_index(axis) * rows_per
    ys, xs = jnp.meshgrid(
        jnp.arange(rows_per, dtype=jnp.int32),
        jnp.arange(w, dtype=jnp.int32),
        indexing="ij",
    )
    return jnp.stack([xs.reshape(-1), (ys + band).reshape(-1)], axis=-1)


def _band_spec(axis: str) -> FilmState:
    return FilmState(rgb_sum=P(axis), weight_sum=P(axis), rgb_splat=P(axis))


def make_sharded_wave_renderer(
    scene,
    camera,
    film: RgbFilm,
    sampler,
    mesh: Mesh,
    integrator: str = "path",
    max_depth: int = 5,
    mode: str = "tiles",
    integrator_options: dict | None = None,
    wavefront: bool | None = None,
):
    """Build the sharded per-wave render function.

    mode="tiles": film rows sharded over the mesh axis; film state must be
    created with :func:`init_sharded_film_state`.
    mode="spp":  film replicated; each device renders every pixel for a
    disjoint slice of sample indices; states are psummed.
    wavefront: None = use the regenerating wavefront (the production
    integrator, see integrators/wavefront.py) whenever the estimator is
    the full path integrator; False forces the masked megakernel.
    """
    li_fn = INTEGRATORS[integrator]
    opts = dict(integrator_options or {})
    use_wavefront = (
        integrator == "path" and not opts if wavefront is None else wavefront
    )
    if use_wavefront:
        from shimmer_tpu.integrators.wavefront import render_wave_wavefront

    w, h = film.resolution
    n_dev = mesh.shape[mesh.axis_names[0]]
    axis = mesh.axis_names[0]
    assert h % n_dev == 0, f"film height {h} not divisible by {n_dev} devices"
    rows_per = h // n_dev

    def _device_render(scene, film_state, sample_indices, pixel_xy, local_film):
        if use_wavefront:
            return render_wave_wavefront(
                scene, camera, local_film, sampler, film_state,
                sample_indices, pixel_xy, None, max_depth=max_depth,
            )
        return render_pixel_samples(
            scene, camera, local_film, sampler, li_fn, opts, film_state,
            sample_indices, pixel_xy, max_depth=max_depth,
        )

    if mode == "tiles":

        def wave_body(scene, film_state: FilmState, sample_indices):
            # Each device renders its row band into its (rows_per, W)
            # shard: global pixel coords for camera rays + sampler
            # seeding, shard-local rows for the film scatter.
            pixel_global = band_pixels(axis, rows_per, w)
            local_film = LocalBandFilm(film, axis, rows_per)
            return _device_render(
                scene, film_state, sample_indices, pixel_global, local_film
            )

        sharded = jax.jit(
            jax.shard_map(
                wave_body,
                mesh=mesh,
                in_specs=(P(), _band_spec(axis), P()),
                out_specs=_band_spec(axis),
                check_vma=False,
            )
        )
        return lambda film_state, idx: sharded(scene, film_state, idx)

    if mode == "spp":
        from shimmer_tpu.render import full_image_pixels

        pixel_xy = full_image_pixels(film)

        def wave_body(scene, film_state: FilmState, sample_indices):
            # sample_indices: (D, n_wave) sharded — each device gets a slice.
            my = sample_indices.reshape(-1)
            fs = _device_render(scene, film_state, my, pixel_xy, film)
            # Cross-device film reduction.
            return jax.tree.map(lambda x: jax.lax.psum(x, axis), fs)

        sharded = jax.jit(
            jax.shard_map(
                wave_body,
                mesh=mesh,
                in_specs=(
                    P(),
                    FilmState(rgb_sum=P(), weight_sum=P(), rgb_splat=P()),
                    P(axis),
                ),
                out_specs=FilmState(rgb_sum=P(), weight_sum=P(), rgb_splat=P()),
                check_vma=False,
            )
        )
        return lambda film_state, idx: sharded(scene, film_state, idx)

    raise ValueError(f"unknown mode: {mode}")


def make_sharded_replay_renderer(
    camera, film: RgbFilm, sampler, mesh: Mesh, max_depth: int = 5
):
    """Row-band-sharded path-replay wave (render.py's
    make_replay_wavefront_renderer on each device's band).

    Returns a jitted ``(scene, film_state, sample_indices) -> film_state``
    over a film state made by :func:`init_sharded_film_state`; it is
    differentiable w.r.t. ``scene``, and a loss summed over the sharded
    film state reduces across devices by itself."""
    axis = mesh.axis_names[0]
    w, h = film.resolution
    n_dev = mesh.shape[axis]
    assert h % n_dev == 0, f"film height {h} not divisible by {n_dev} devices"
    rows_per = h // n_dev

    def body(scene, film_state, sample_indices):
        replay = make_replay_wavefront_renderer(
            scene, camera, LocalBandFilm(film, axis, rows_per), sampler,
            max_depth=max_depth,
        )
        pixel_global = band_pixels(axis, rows_per, w)
        return replay(scene, film_state, sample_indices, pixel_global, None)

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), _band_spec(axis), P()),
            out_specs=_band_spec(axis),
            check_vma=False,
        )
    )


class LocalBandFilm:
    """Film view whose scatter indices are shard-local rows.  The band's
    first row is read from the mesh axis where it is used, so the view
    holds no traced value (the replay's custom VJP may close over it)."""

    def __init__(self, film: RgbFilm, axis: str, rows_per: int):
        self._film = film
        self._axis = axis
        self._rows_per = rows_per

    def __getattr__(self, name):
        return getattr(self._film, name)

    def local_xy(self, pixel_xy):
        band = jax.lax.axis_index(self._axis) * self._rows_per
        return jnp.stack([pixel_xy[..., 0], pixel_xy[..., 1] - band], axis=-1)

    def add_samples(self, state, pixel_xy, l, swl, weight, unique=False):
        return self._film.add_samples(
            state, self.local_xy(pixel_xy), l, swl, weight, unique=unique
        )


def init_sharded_film_state(film: RgbFilm, mesh: Mesh) -> FilmState:
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        film.init_state(),
        _band_spec(mesh.axis_names[0]),
    )


def render_sharded(
    scene,
    camera,
    film: RgbFilm,
    sampler,
    mesh: Mesh | None = None,
    integrator: str = "path",
    spp: int | None = None,
    max_depth: int = 5,
    wave_spp: int = 4,
    mode: str = "tiles",
    integrator_options: dict | None = None,
    wavefront: bool | None = None,
):
    """Multi-device render loop; same contract as shimmer_tpu.render.render."""
    mesh = mesh or make_tile_mesh()
    spp = spp if spp is not None else sampler.samples_per_pixel
    wave_fn = make_sharded_wave_renderer(
        scene, camera, film, sampler, mesh, integrator, max_depth, mode,
        integrator_options, wavefront=wavefront,
    )
    n_dev = mesh.shape[mesh.axis_names[0]]
    if mode == "tiles":
        state = init_sharded_film_state(film, mesh)
        start = 0
        while start < spp:
            n = min(wave_spp, spp - start)
            idx = jnp.arange(start, start + n, dtype=jnp.uint32)
            state = wave_fn(state, idx)
            start += n
    else:  # spp mode: pad spp to a multiple of devices
        state = film.init_state()
        start = 0
        while start < spp:
            n = min(wave_spp * n_dev, spp - start)
            n = max(n_dev, (n // n_dev) * n_dev)
            idx = jnp.arange(start, start + n, dtype=jnp.uint32).reshape(n_dev, -1)
            state = wave_fn(state, idx)
            start += n
    image = film.get_image(state)
    return image, state
