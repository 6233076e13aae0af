"""Golden-image regression tests (VERDICT r2 #10).

Renders the committed mini .pbrt scenes at their in-file sampler
settings and compares against checked-in goldens.  Renders are
deterministic (ZSobol + counter RNG), so the tolerance only absorbs
benign numeric drift from op reordering; a real behavior change trips
the gate.  Regenerate after an *intentional* change with:

    python tests/scenes/gen_goldens.py [scene ...]
"""

import pathlib

import numpy as np
import pytest

from shimmer_tpu.film.image import (
    GOLDEN_MEAN_REL,
    GOLDEN_P99_REL,
    relative_drift,
)

SCENES_DIR = pathlib.Path(__file__).parent / "scenes"
SCENES = ["diffuse_box", "conductor_env", "dielectric"]


def render_scene(name: str) -> np.ndarray:
    from shimmer_tpu.loading.parser import parse_file
    from shimmer_tpu.loading.scene_builder import SceneBuilder
    from shimmer_tpu.render import render

    builder = SceneBuilder(search_dir=SCENES_DIR)
    parse_file(str(SCENES_DIR / f"{name}.pbrt"), builder)
    job = builder.create()
    image, _ = render(
        job.scene, job.camera, job.film, job.sampler,
        integrator=job.integrator, spp=job.spp, max_depth=job.max_depth,
    )
    return np.asarray(image)


@pytest.mark.parametrize(
    "name",
    [
        SCENES[0],
        # Each scene pays a full wave-program compile (~80s CPU); the
        # diffuse box covers the default path, the rest run under -m slow.
        pytest.param(SCENES[1], marks=pytest.mark.slow),
        pytest.param(SCENES[2], marks=pytest.mark.slow),
    ],
)
def test_golden(name):
    golden_path = SCENES_DIR / f"golden_{name}.npz"
    assert golden_path.exists(), (
        f"missing golden for {name}; run python tests/scenes/gen_goldens.py"
    )
    golden = np.load(golden_path)["image"]
    img = render_scene(name)
    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    mean_rel, p99_rel = relative_drift(img, golden)
    assert mean_rel < GOLDEN_MEAN_REL, f"{name}: mean drift {mean_rel:.4f}"
    assert p99_rel < GOLDEN_P99_REL, f"{name}: p99 drift {p99_rel:.4f}"
