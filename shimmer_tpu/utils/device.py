"""Which accelerator a measurement ran on.

``card_info`` asks ``nvidia-smi`` in a subprocess, so it can run before
JAX touches the card.  ``require_gpu`` is the guard of every script that
measures or checks the card: without a GPU it exits, it never falls back
to the CPU.
"""

from __future__ import annotations

import subprocess
import sys


def card_info() -> str:
    """``name, power.limit`` of each visible NVIDIA card, one per line,
    as ``nvidia-smi`` prints them; "unavailable" without the tool."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return out or "unavailable"


def require_gpu(what: str) -> dict:
    """Exit with status 1 unless JAX's default backend is a GPU; return
    the device description every result is printed with."""
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"{what} needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r}",
            file=sys.stderr,
        )
        sys.exit(1)
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
