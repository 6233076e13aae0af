"""Multi-host distribution: jax.distributed init + cross-host film path.

The reference is single-process (SURVEY.md §2 parallelism table: rayon
threads, no networking).  Across hosts:

* one JAX process per host, connected with ``jax.distributed.initialize``;
* the film's pixel rows sharded over the GLOBAL device mesh with the
  existing tile renderer (parallel/render.py) — rays are independent, so
  a wave needs NO cross-host traffic;
* the only collectives are the film resolve (all-gather of row bands)
  and, in training, the gradient psum — both ride the mesh axis.

Verified without a cluster by the 2-process CPU dry run
(``python experiments/dryrun_multihost.py``), the standard JAX substitute
prescribed in SURVEY.md §4: each process exposes
``xla_force_host_platform_device_count`` fake devices and the global mesh
spans both processes.
"""

from __future__ import annotations

import os

import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Connect this process to the multi-host job.

    Arguments default to the env vars SHIMMER_COORDINATOR /
    SHIMMER_NUM_PROCESSES / SHIMMER_PROCESS_ID.  With none of them given,
    nothing is initialised (a single-process run).  Idempotent.
    """
    import jax
    from jax._src.distributed import global_state

    if global_state.client is not None:
        return  # already initialized (must not touch the backend here:
        #         jax.process_count() would initialise XLA too early)
    kw = {}
    coordinator_address = coordinator_address or os.environ.get(
        "SHIMMER_COORDINATOR"
    )
    if coordinator_address:
        kw["coordinator_address"] = coordinator_address
    n = num_processes or os.environ.get("SHIMMER_NUM_PROCESSES")
    if n is not None:
        kw["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get(
        "SHIMMER_PROCESS_ID"
    )
    if pid is not None:
        kw["process_id"] = int(pid)
    if kw:
        jax.distributed.initialize(**kw)


def global_mesh(axis: str = "tiles"):
    """Mesh over every device in the job (all hosts)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def render_multihost(
    scene,
    camera,
    film,
    sampler,
    integrator: str = "path",
    spp: int | None = None,
    max_depth: int = 5,
    wave_spp: int = 4,
):
    """Row-band-sharded render over the global (multi-host) mesh.

    Every process calls this with the SAME scene (replicated — a
    multi-M-triangle BVH fits one device's memory, SURVEY.md §7
    hard-part 7).  Returns the full resolved image, identical on every
    process (gathered with process_allgather).
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from shimmer_tpu.parallel.render import (
        init_sharded_film_state,
        make_sharded_wave_renderer,
    )

    spp = spp if spp is not None else sampler.samples_per_pixel
    mesh = global_mesh()
    wave_fn = make_sharded_wave_renderer(
        scene, camera, film, sampler, mesh,
        integrator=integrator, max_depth=max_depth, mode="tiles",
    )
    state = init_sharded_film_state(film, mesh)
    start = 0
    while start < spp:
        n = min(wave_spp, spp - start)
        idx = jnp.arange(start, start + n, dtype=jnp.uint32)
        state = wave_fn(state, idx)
        start += n

    # Resolve locally per row band, then all-gather bands across hosts.
    image = film.get_image(state)           # sharded (H, W, 3)
    return multihost_utils.process_allgather(image, tiled=True)
