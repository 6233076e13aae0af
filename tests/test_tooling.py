"""Entry-point plumbing: the compile-cache policy, the native builder's
build key, and the device guard of the GPU-only scripts."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_policy(monkeypatch, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the helper leaves the choice to
    JAX; without it the cache is <checkout>/.jax_cache."""
    import jax

    from shimmer_tpu.utils import compile_cache

    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: updates.append((name, value))
    )
    got = compile_cache.enable_compile_cache()
    if env_dir is None:
        assert got == str(ROOT / ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", got)]
    else:
        assert got == env_dir
        assert updates == []


def test_native_build_is_keyed_on_source_hash():
    from shimmer_tpu import native

    src = (ROOT / "shimmer_tpu" / "native" / "sah.cpp").read_bytes()
    path = native.library_path(src)
    assert pathlib.Path(path).parent == ROOT / "shimmer_tpu" / "native"
    assert native.library_path(src) == path
    assert native.library_path(src + b"\n// edited\n") != path
    assert native.sah_available()
    assert os.path.exists(path)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_the_cpu(script):
    """Without a GPU the scripts exit non-zero before rendering anything
    and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / script)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok": true' not in out.stdout
    assert "phase " not in out.stdout
