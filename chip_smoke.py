#!/usr/bin/env python3
"""Smoke test of the renderer's main path on NVIDIA GPUs.

    python chip_smoke.py               # one card, phases 1-6
    python chip_smoke.py --four-cards  # four cards: the sharded frame and
                                       # the sharded replay gradient only

One process drives the card(s).  Phases, in order:

1. device check: JAX's default backend is a GPU (no CPU fallback);
2. the native BVH builder is available;
3. the traversal kernel (``traversal="auto"`` on a GPU) against the XLA
   reference ``_traverse`` on the production scene (327,684 triangles):
   2^17 coherent primary and 2^17 incoherent bounce rays, closest-hit,
   then a mixed any-hit/closest batch;
4. the production frame through ``render.render``: 1280x720, spp 16,
   max depth 5, regenerating wavefront;
5. the three pbrt scenes with goldens through ``cli.main``, each held to
   the golden tolerance of tests/test_golden.py;
6. path-replay value-and-grad on one 2^17-pixel block of the production
   frame, and a finite-difference check at the size and tolerance of the
   CPU gradient tests.

Each phase prints one line with its compile and run time, the device's
``peak_bytes_in_use`` so far, and the card.  Any failed phase ends the
run with a non-zero status.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_TRIS = 300000        # 327,684 triangles with the floor and the light
RES = (1280, 720)
SPP = 16
MAX_DEPTH = 5
N_RAYS = 1 << 17
GRAD_BLOCK = 1 << 17
# Sharded and one-card renders trace the same sample streams; only
# floating-point reordering between two programs separates them.
SHARD_IMAGE_MEAN_REL = 1e-4
SHARD_IMAGE_P99_REL = 1e-3
SHARD_GRAD_RTOL = 1e-4


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def phase(self, name, fn):
        """Run one phase: fn returns (compile_s, run_s, details)."""
        import jax

        print(f"phase {name}: start", flush=True)
        compile_s, run_s, details = fn()
        stats = jax.devices()[0].memory_stats() or {}
        print(
            f"phase {name}: ok compile_s={compile_s:.2f} run_s={run_s:.3f} "
            f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
            f"card={self.card!r} {json.dumps(details, default=float)}",
            flush=True,
        )
        return details


@contextlib.contextmanager
def step(label):
    """A start and a done line around one step of a phase, so that a run
    cut by its time limit shows which step it was in."""
    print(f"  {label}: start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"  {label}: done {time.perf_counter() - t0:.2f} s", flush=True)


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_native():
    from shimmer_tpu import native

    assert native.sah_available(), "native SAH builder unavailable"
    return 0.0, 0.0, {"sah_available": True}


def _production_scene(res=RES):
    from bench import build_bench_scene

    return build_bench_scene(N_TRIS, res)


def compare_hits(t_k, tri_k, t_x, tri_x, any_hit):
    """Kernel vs reference, lane by lane.  Closest-hit lanes: the same
    triangle, except on genuine ties (same t within 1e-5); any-hit lanes:
    the same occlusion.  Returns the mismatch counts."""
    import numpy as np

    t_k, tri_k, t_x, tri_x, any_hit = map(
        np.asarray, (t_k, tri_k, t_x, tri_x, any_hit)
    )
    hit_k, hit_x = tri_k >= 0, tri_x >= 0
    closest = ~any_hit
    both = closest & hit_k & hit_x
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(t_k - t_x) / np.abs(t_x)
    tie = both & (tri_k != tri_x)
    out = {
        "hits": int(hit_x.sum()),
        "tri_differs": int(tie.sum()),
        "max_rel_t_gap_where_tri_differs": float(rel[tie].max(initial=0.0)),
        "max_rel_t_gap": float(rel[both].max(initial=0.0)),
        "hit_differs": int((hit_k != hit_x).sum()),
    }
    assert out["hit_differs"] == 0, out
    assert out["max_rel_t_gap"] <= 1e-5, out
    return out


def phase_traversal(scene, cam, film):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import primary_and_bounce_rays
    from shimmer_tpu.shapes.triangle import _traverse, _traverse_raw

    tris = scene.triangles
    kernel = jax.jit(lambda t, o, d, tm, wa: _traverse_raw(t, o, d, tm, wa))
    ref = jax.jit(
        lambda t, o, d, tm, wa: _traverse(t, o, d, tm, any_hit=wa, raw=True)
    )
    rng = np.random.default_rng(5)
    closest = jnp.zeros(N_RAYS, bool)
    want = rng.random(N_RAYS) < 0.5
    t_mixed = np.where(want, rng.uniform(0.2, 3.0, N_RAYS), np.inf)
    t_mixed[rng.random(N_RAYS) < 0.25] = -np.inf   # dead wavefront lanes
    batches = []
    for name, (o, d) in primary_and_bounce_rays(cam, film, N_RAYS).items():
        batches.append((name, o, d, jnp.full(N_RAYS, jnp.inf), closest))
    o, d = batches[1][1], batches[1][2]
    batches.append(
        ("mixed", o, d, jnp.asarray(t_mixed, jnp.float32), jnp.asarray(want))
    )

    args0 = (tris,) + batches[0][1:]
    assert "pallas_call" in str(jax.make_jaxpr(kernel)(*args0)), (
        "traversal='auto' did not take the kernel"
    )
    t0 = time.perf_counter()
    kernel_c = kernel.lower(*args0).compile()
    ref_c = ref.lower(*args0).compile()
    compile_s = time.perf_counter() - t0
    details, run_s = {}, 0.0
    for name, o, d, tm, wa in batches:
        (t_k, tri_k), dt_k = _timed(kernel_c, tris, o, d, tm, wa)
        (t_x, tri_x), dt_x = _timed(ref_c, tris, o, d, tm, wa)
        run_s += dt_k + dt_x
        res = compare_hits(t_k, tri_k, t_x, tri_x, wa)
        for label, fn in (("kernel", kernel_c), ("xla", ref_c)):
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                r = fn(tris, o, d, tm, wa)
            jax.block_until_ready(r)
            res[f"{label}_ms"] = (time.perf_counter() - t0) / reps * 1e3
        details[name] = res
    return compile_s, run_s, details


def phase_frame(scene, cam, film):
    """The frame through render() twice (the second must be bit-identical),
    then its steady-state time with the kernel and with the XLA traversal:
    render()'s own wave loop over a wave function that is already compiled
    (render() traces anew per call)."""
    import jax.numpy as jnp
    import numpy as np

    from shimmer_tpu.film.image import (
        GOLDEN_MEAN_REL,
        GOLDEN_P99_REL,
        relative_drift,
    )
    from shimmer_tpu.render import (
        DEFAULT_PIXEL_BLOCK,
        make_wavefront_renderer,
        pixel_blocks,
        render,
    )
    from shimmer_tpu.samplers import ZSobolSampler

    w, h = film.resolution
    sampler = ZSobolSampler(SPP, (w, h))

    def frame():
        img, _ = render(
            scene, cam, film, sampler, spp=SPP, max_depth=MAX_DEPTH,
            wave_spp=SPP,
        )
        return np.asarray(img)

    with step("render() first call"):
        first, first_s = _timed(frame)
    with step("render() second call"):
        second, second_s = _timed(frame)
    assert np.isfinite(second).all(), "non-finite pixels"
    mean = float(second.mean())
    assert mean > 0, "black frame"

    blocks, valids = pixel_blocks(film, DEFAULT_PIXEL_BLOCK)
    idx = jnp.arange(SPP, dtype=jnp.uint32)
    steady_s, compile_s, images = {}, {}, {}
    for traversal in ("auto", "xla"):
        tris = dataclasses.replace(scene.triangles, traversal=traversal)
        wave = make_wavefront_renderer(
            dataclasses.replace(scene, triangles=tris), cam, film, sampler,
            max_depth=MAX_DEPTH,
        )

        def steady():
            state = film.init_state()
            for b in range(blocks.shape[0]):
                state = wave(state, idx, blocks[b], valids[b])
            return state

        with step(f"frame, traversal={traversal!r}"):
            _, first_wave_s = _timed(steady)
            state, steady_s[traversal] = _timed(steady)
        compile_s[traversal] = first_wave_s - steady_s[traversal]
        images[traversal] = np.asarray(film.get_image(state))
    # The two traversals may flip near-edge hits (FMA contraction): the
    # frames are held to the golden tolerance, not to bit equality.
    mean_rel, p99_rel = relative_drift(images["xla"], images["auto"])
    assert mean_rel < GOLDEN_MEAN_REL and p99_rel < GOLDEN_P99_REL, (
        mean_rel, p99_rel,
    )
    run_s = steady_s["auto"]
    return compile_s["auto"], run_s, {
        "resolution": [w, h], "spp": SPP, "mean": mean,
        "pixel_samples_per_s": w * h * SPP / run_s,
        "bit_identical_rerun": bool((first == second).all()),
        "render_first_call_s": first_s, "render_second_call_s": second_s,
        "frame_kernel_s": steady_s["auto"], "frame_xla_s": steady_s["xla"],
        "frame_xla_compile_s": compile_s["xla"],
        "xla_vs_kernel_mean_rel": mean_rel, "xla_vs_kernel_p99_rel": p99_rel,
        "steady_equals_render": bool((images["auto"] == second).all()),
    }


def phase_goldens():
    import numpy as np

    from shimmer_tpu import cli
    from shimmer_tpu.film.image import (
        GOLDEN_MEAN_REL,
        GOLDEN_P99_REL,
        Image,
        relative_drift,
    )

    scenes_dir = ROOT / "tests" / "scenes"
    details, run_s = {}, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("diffuse_box", "conductor_env", "dielectric"):
            out = pathlib.Path(tmp) / f"{name}.pfm"
            t0 = time.perf_counter()
            rc = cli.main(
                [str(scenes_dir / f"{name}.pbrt"), "--outfile", str(out), "-q"]
            )
            run_s += time.perf_counter() - t0
            assert rc == 0, f"{name}: cli exit {rc}"
            img = Image.read(out).data
            golden = np.load(scenes_dir / f"golden_{name}.npz")["image"]
            assert img.shape == golden.shape, (img.shape, golden.shape)
            assert np.isfinite(img).all(), f"{name}: non-finite pixels"
            mean_rel, p99_rel = relative_drift(img, golden)
            details[name] = {"mean_rel": mean_rel, "p99_rel": p99_rel}
            assert mean_rel < GOLDEN_MEAN_REL, (name, details[name])
            assert p99_rel < GOLDEN_P99_REL, (name, details[name])
    # Each scene compiles its own program: the time is compile + run.
    return run_s, 0.0, details


def _reflectance_loss(scene, render_fn):
    """loss(theta): reflectance[0, 1] (the sphere's green) -> mean film
    radiance, and theta's starting value."""
    import jax.numpy as jnp

    def loss(theta):
        mats = dataclasses.replace(
            scene.materials,
            reflectance=scene.materials.reflectance.at[0, 1].set(theta),
        )
        fs = render_fn(dataclasses.replace(scene, materials=mats))
        return jnp.sum(fs.rgb_sum) / fs.weight_sum.size

    return loss, jnp.float32(scene.materials.reflectance[0, 1])


def phase_replay(scene, cam, film):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from shimmer_tpu.render import make_replay_wavefront_renderer, pixel_blocks
    from shimmer_tpu.samplers import IndependentSampler, ZSobolSampler

    w, h = film.resolution
    sampler = ZSobolSampler(SPP, (w, h))
    replay = make_replay_wavefront_renderer(
        scene, cam, film, sampler, max_depth=MAX_DEPTH
    )
    blocks, valids = pixel_blocks(film, GRAD_BLOCK)
    idx = jnp.arange(SPP, dtype=jnp.uint32)
    loss, theta0 = _reflectance_loss(
        scene,
        lambda sc: replay(sc, film.init_state(), idx, blocks[0], valids[0]),
    )
    vg = jax.jit(jax.value_and_grad(loss))
    (v, g), first_s = _timed(vg, theta0)
    (v, g), run_s = _timed(vg, theta0)
    assert np.isfinite(float(v)) and np.isfinite(float(g)), (v, g)
    assert float(g) != 0.0, "zero gradient"
    details = {"block_pixels": GRAD_BLOCK, "spp": SPP, "value": float(v),
               "grad": float(g)}

    # Finite differences at the CPU tests' size and tolerance
    # (tests/test_grad.py: 12x12 pixels, 32 spp, depth 3, h 1e-2, rtol 5e-2).
    small_scene, small_cam, small_film, _ = _production_scene((12, 12))
    small = make_replay_wavefront_renderer(
        small_scene, small_cam, small_film, IndependentSampler(32),
        max_depth=3,
    )
    px, valid = pixel_blocks(small_film, 144)
    idx32 = jnp.arange(32, dtype=jnp.uint32)
    f, theta0 = _reflectance_loss(
        small_scene,
        lambda sc: small(sc, small_film.init_state(), idx32, px[0], valid[0]),
    )
    f_jit = jax.jit(f)
    g_ad = float(jax.jit(jax.grad(f))(theta0))
    h_fd = 1e-2
    g_fd = float((f_jit(theta0 + h_fd) - f_jit(theta0 - h_fd)) / (2 * h_fd))
    details.update(fd_grad_ad=g_ad, fd_grad_fd=g_fd)
    np.testing.assert_allclose(g_ad, g_fd, rtol=5e-2)
    assert abs(g_ad) > 1e-7
    return first_s - run_s, run_s, details


def phase_four_cards_frame(scene, cam, film, mesh):
    """render_sharded() against the one-card render(), then the steady
    frame time of each: its wave function, already compiled, called
    again."""
    import jax.numpy as jnp
    import numpy as np

    from shimmer_tpu.film.image import relative_drift
    from shimmer_tpu.parallel.render import (
        init_sharded_film_state,
        make_sharded_wave_renderer,
        render_sharded,
    )
    from shimmer_tpu.render import (
        DEFAULT_PIXEL_BLOCK,
        make_wavefront_renderer,
        pixel_blocks,
        render,
    )
    from shimmer_tpu.samplers import ZSobolSampler

    w, h = film.resolution
    sampler = ZSobolSampler(SPP, (w, h))
    kw = dict(spp=SPP, max_depth=MAX_DEPTH, wave_spp=SPP)
    with step("one-card render()"):
        one, one_s = _timed(
            lambda: np.asarray(render(scene, cam, film, sampler, **kw)[0])
        )
    with step("render_sharded()"):
        four, first_s = _timed(
            lambda: np.asarray(
                render_sharded(scene, cam, film, sampler, mesh, **kw)[0]
            )
        )
    mean_rel, p99_rel = relative_drift(four, one)
    details = {
        "devices": mesh.devices.size, "rows_per_device": h // mesh.devices.size,
        "render_one_card_s": one_s, "render_sharded_s": first_s,
        "mean_rel": mean_rel, "p99_rel": p99_rel,
        "max_abs_diff": float(np.abs(four - one).max()),
        "bit_identical": bool((four == one).all()),
    }
    assert np.isfinite(four).all() and four.mean() > 0, details
    assert mean_rel < SHARD_IMAGE_MEAN_REL and p99_rel < SHARD_IMAGE_P99_REL, details

    idx = jnp.arange(SPP, dtype=jnp.uint32)
    wave1 = make_wavefront_renderer(scene, cam, film, sampler, max_depth=MAX_DEPTH)
    blocks, valids = pixel_blocks(film, DEFAULT_PIXEL_BLOCK)

    def one_card():
        state = film.init_state()
        for b in range(blocks.shape[0]):
            state = wave1(state, idx, blocks[b], valids[b])
        return state

    wave4 = make_sharded_wave_renderer(
        scene, cam, film, sampler, mesh, max_depth=MAX_DEPTH
    )
    for name, fn in (
        ("one_card", one_card),
        ("sharded", lambda: wave4(init_sharded_film_state(film, mesh), idx)),
    ):
        with step(f"steady frame, {name}"):
            _timed(fn)
            details[f"steady_{name}_s"] = _timed(fn)[1]
    run_s = details["steady_sharded_s"]
    details["speedup"] = details["steady_one_card_s"] / run_s
    return first_s - run_s, run_s, details


def phase_four_cards_grad(mesh):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from shimmer_tpu.parallel.render import (
        init_sharded_film_state,
        make_sharded_replay_renderer,
    )
    from shimmer_tpu.render import full_image_pixels, make_replay_wavefront_renderer
    from shimmer_tpu.samplers import ZSobolSampler

    # A quarter-resolution frame keeps the one-card reference in memory.
    scene, cam, film, _ = _production_scene((320, 180))
    w, h = film.resolution
    sampler = ZSobolSampler(4, (w, h))
    idx = jnp.arange(4, dtype=jnp.uint32)
    sharded = make_sharded_replay_renderer(cam, film, sampler, mesh, MAX_DEPTH)
    single = make_replay_wavefront_renderer(scene, cam, film, sampler, MAX_DEPTH)
    px = full_image_pixels(film)
    valid = jnp.ones(px.shape[0], bool)
    loss4, theta0 = _reflectance_loss(
        scene, lambda sc: sharded(sc, init_sharded_film_state(film, mesh), idx)
    )
    loss1, _ = _reflectance_loss(
        scene, lambda sc: single(sc, film.init_state(), idx, px, valid)
    )
    vg4 = jax.jit(jax.value_and_grad(loss4))
    with step("one-card value-and-grad"):
        (v1, g1), _ = _timed(jax.jit(jax.value_and_grad(loss1)), theta0)
    with step("sharded value-and-grad, first call"):
        (v4, g4), first_s = _timed(vg4, theta0)
    with step("sharded value-and-grad, second call"):
        (v4, g4), run_s = _timed(vg4, theta0)
    details = {"resolution": [w, h], "value_1": float(v1), "value_4": float(v4),
               "grad_1": float(g1), "grad_4": float(g4)}
    assert float(g1) != 0.0, details
    np.testing.assert_allclose(float(v4), float(v1), rtol=SHARD_GRAD_RTOL)
    np.testing.assert_allclose(float(g4), float(g1), rtol=SHARD_GRAD_RTOL)
    return first_s - run_s, run_s, details


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card sharded frame and gradient",
    )
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from shimmer_tpu.utils.device import card_info, require_gpu

    card = card_info()   # before JAX opens the card
    device = require_gpu("chip_smoke.py")          # phase 1
    import jax

    from shimmer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smoke = Smoke(card.replace("\n", " | "))
    smoke.phase("1 device", lambda: (0.0, 0.0, device))
    if args.four_cards:
        from shimmer_tpu.parallel.render import make_tile_mesh

        assert device["count"] >= 4, f"--four-cards needs 4 GPUs: {device}"
        mesh = make_tile_mesh(jax.devices()[:4])
        scene, cam, film, _ = _production_scene()
        smoke.phase("4x frame", lambda: phase_four_cards_frame(scene, cam, film, mesh))
        smoke.phase("4x replay grad", lambda: phase_four_cards_grad(mesh))
    else:
        smoke.phase("2 native builder", phase_native)
        scene, cam, film, _ = _production_scene()
        smoke.phase("3 traversal", lambda: phase_traversal(scene, cam, film))
        smoke.phase("4 frame", lambda: phase_frame(scene, cam, film))
        smoke.phase("5 goldens", phase_goldens)
        smoke.phase("6 replay grad", lambda: phase_replay(scene, cam, film))
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
