"""Command-line renderer.

TPU-native analog of /root/reference/src/main.rs: parse a pbrt-v4 scene,
render, write the image, print the render time.

    python -m shimmer_tpu.cli scene.pbrt [--outfile out.pfm] [--spp N] ...
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    from shimmer_tpu.render import DEFAULT_PIXEL_BLOCK

    ap = argparse.ArgumentParser(
        prog="shimmer-tpu", description="Differentiable spectral path tracer"
    )
    ap.add_argument("scene", help="pbrt-v4 scene file")
    ap.add_argument("--outfile", "-o", default=None, help="output image (.pfm/.png/.exr)")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--integrator", default=None, choices=["path", "simplepath", "randomwalk"])
    ap.add_argument("--wave-spp", type=int, default=4)
    ap.add_argument("--pixel-block", type=int, default=DEFAULT_PIXEL_BLOCK)
    ap.add_argument("--shard", action="store_true", help="shard across all local devices")
    ap.add_argument(
        "--megakernel", action="store_true",
        help="force the masked megakernel instead of the wavefront integrator",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="persist film state every --checkpoint-every waves and "
        "auto-resume from PATH (bit-identical; SURVEY §5)",
    )
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--quiet", "-q", action="store_true")
    ap.add_argument(
        "--stats", action="store_true",
        help="print a statistics report after rendering (pbrt --stats)",
    )
    args = ap.parse_args(argv)

    from pathlib import Path

    from shimmer_tpu.film.image import Image
    from shimmer_tpu.loading.parser import parse_file
    from shimmer_tpu.loading.scene_builder import SceneBuilder
    from shimmer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.time()
    builder = SceneBuilder(search_dir=Path(args.scene).parent)
    parse_file(args.scene, builder)
    job = builder.create()
    if not args.quiet:
        print(f"scene build: {time.time() - t0:.2f}s", file=sys.stderr)

    spp = args.spp or job.spp
    max_depth = args.maxdepth or job.max_depth
    integrator = args.integrator or job.integrator

    t0 = time.time()

    def progress(done, total):
        if not args.quiet:
            print(f"\r{done}/{total} spp", end="", file=sys.stderr, flush=True)

    if args.shard:
        from shimmer_tpu.parallel.render import render_sharded

        image, _ = render_sharded(
            job.scene, job.camera, job.film, job.sampler,
            integrator=integrator, spp=spp, max_depth=max_depth,
            wave_spp=args.wave_spp,
            wavefront=False if args.megakernel else None,
        )
    else:
        from shimmer_tpu.render import render

        image, _ = render(
            job.scene, job.camera, job.film, job.sampler,
            integrator=integrator, spp=spp, max_depth=max_depth,
            wave_spp=args.wave_spp, pixel_block=args.pixel_block,
            progress=progress,
            disable_pixel_jitter=job.disable_pixel_jitter,
            disable_wavelength_jitter=job.disable_wavelength_jitter,
            wavefront=False if args.megakernel else None,
            collect_stats=args.stats,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
        )
    import numpy as np

    img = np.asarray(image)
    if not args.quiet:
        print(f"\nrender: {time.time() - t0:.2f}s", file=sys.stderr)

    out = args.outfile or job.filename
    Image(img).write(out)
    if not args.quiet:
        print(f"wrote {out}", file=sys.stderr)
    if args.stats:
        from shimmer_tpu.utils import stats

        print(stats.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
