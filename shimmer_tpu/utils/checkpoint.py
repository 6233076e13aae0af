"""Per-wave render checkpoint/resume.

SURVEY.md §5 names film+RNG checkpointing per wave as this renderer's
natural aux subsystem (the reference's wave structure is
checkpoint-shaped but persists nothing, integrator.rs:310-319).  Here a
checkpoint is exact: the film accumulators (FilmState) plus the wave
cursor.  The sampler is a counter-based stream keyed by
(pixel, sample_index) — no RNG state needs saving — so resuming replays
the remaining (wave, block) pairs and produces a bit-identical image.

Format: a single .npz written atomically (tmp + os.replace) holding the
three film planes, the spp cursor, and a JSON fingerprint of the render
configuration.  A fingerprint mismatch invalidates the checkpoint (it is
ignored, not an error)."""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


class RenderCheckpointer:
    """Atomic .npz checkpoints of (FilmState, wave cursor)."""

    def __init__(self, path, fingerprint: dict | None = None):
        self.path = os.fspath(path)
        self.fingerprint = json.dumps(
            fingerprint or {}, sort_keys=True, default=str
        )

    def save(self, film_state, spp_done: int) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    rgb_sum=np.asarray(film_state.rgb_sum),
                    weight_sum=np.asarray(film_state.weight_sum),
                    rgb_splat=np.asarray(film_state.rgb_splat),
                    spp_done=np.int64(spp_done),
                    fingerprint=np.frombuffer(
                        self.fingerprint.encode(), dtype=np.uint8
                    ),
                )
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self):
        """Returns (film_state_arrays dict, spp_done) or None when absent
        or stale (fingerprint mismatch / unreadable)."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path) as z:
                fp = bytes(z["fingerprint"]).decode()
                if fp != self.fingerprint:
                    import warnings

                    warnings.warn(
                        "checkpoint fingerprint mismatch - ignoring "
                        f"{self.path}"
                    )
                    return None
                return (
                    {
                        "rgb_sum": z["rgb_sum"],
                        "weight_sum": z["weight_sum"],
                        "rgb_splat": z["rgb_splat"],
                    },
                    int(z["spp_done"]),
                )
        except (OSError, ValueError, KeyError) as e:
            import warnings

            warnings.warn(f"unreadable checkpoint {self.path}: {e}")
            return None

    def remove(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
