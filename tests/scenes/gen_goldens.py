"""Regenerate golden images for tests/test_golden.py.

Usage: python tests/scenes/gen_goldens.py [scene ...]
Run on the CPU (JAX_PLATFORMS=cpu): the goldens are CPU-made.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from test_golden import SCENES, SCENES_DIR, render_scene

if __name__ == "__main__":
    names = sys.argv[1:] or SCENES
    for name in names:
        img = render_scene(name)
        out = SCENES_DIR / f"golden_{name}.npz"
        np.savez_compressed(out, image=img.astype(np.float32))
        print(f"{name}: mean {img.mean():.5f}  -> {out}")
