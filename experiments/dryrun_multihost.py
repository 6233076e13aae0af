"""2-process CPU dry run of the multi-host path (SURVEY.md §4's
substitute for a real pod): each process gets 4 fake CPU devices, the
global mesh spans 8 devices across both processes, and the row-band
sharded renderer produces an image every process agrees on.

Run (parent spawns both workers and checks):   python experiments/dryrun_multihost.py
Worker mode (spawned):                         ... worker <pid>
"""

import os
import subprocess
import sys

N_PROC = 2
N_LOCAL = 4
PORT = int(os.environ.get("DRYRUN_PORT", "56789"))


def worker(process_id: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={N_LOCAL}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from shimmer_tpu.parallel.distributed import (
        initialize_distributed,
        render_multihost,
    )

    initialize_distributed(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=process_id,
    )
    assert jax.process_count() == N_PROC, jax.process_count()
    assert len(jax.devices()) == N_PROC * N_LOCAL, len(jax.devices())

    import __graft_entry__ as ge

    from shimmer_tpu.samplers import IndependentSampler

    scene, cam, film = ge._flagship(res=(16, 16))
    sampler = IndependentSampler(2, seed=3)
    img = render_multihost(
        scene, cam, film, sampler, spp=2, max_depth=2, wave_spp=2
    )
    import numpy as np

    img = np.asarray(img)
    assert np.isfinite(img).all() and img.mean() > 0, img.mean()
    print(f"WORKER{process_id} OK mean={img.mean():.6f}", flush=True)


def main():
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(N_PROC)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    means = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        ok = p.returncode == 0 and f"WORKER{i} OK" in out
        if not ok:
            print(f"--- worker {i} rc={p.returncode} ---\n{out[-3000:]}")
            sys.exit(1)
        means.append(out.split(f"WORKER{i} OK mean=")[1].split()[0])
    assert means[0] == means[1], f"hosts disagree: {means}"
    print(f"MULTIHOST DRYRUN OK: {N_PROC} processes x {N_LOCAL} devices, "
          f"mean={means[0]}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]))
    else:
        main()
