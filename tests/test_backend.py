"""Backend capability table, compile-cache rule, and the no-fallback
guarantees (svdfeature_tpu/backend.py, solvers/base._init_mesh,
chip_smoke.py)."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdfeature_tpu import backend

ROOT = pathlib.Path(__file__).parent.parent


def test_cpu_row_gives_plain_forms():
    caps = backend.capabilities_for("cpu")
    assert caps == backend.Capabilities(
        "cpu", onehot_scatter=False, accelerator=False
    )


def test_gpu_row_is_an_accelerator():
    caps = backend.capabilities_for("gpu")
    assert caps.accelerator and not caps.onehot_scatter


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no backend capabilities"):
        backend.capabilities_for(platform)


def test_detected_row_is_the_default_backend():
    assert backend.capabilities().platform == jax.devices()[0].platform == "cpu"


def test_override_replaces_and_restores():
    before = backend.capabilities()
    with backend.override(onehot_scatter=True, accelerator=True) as caps:
        assert backend.capabilities() is caps
        assert caps.onehot_scatter and caps.accelerator
        assert caps.platform == before.platform
    assert backend.capabilities() == before


def test_onehot_selector_follows_the_table():
    from svdfeature_tpu.ops import embed

    assert not embed._use_onehot(16)
    with backend.override(onehot_scatter=True):
        assert embed._use_onehot(16)
        assert not embed._use_onehot(embed.ONEHOT_THRESHOLD + 1)


# ---- compile cache -------------------------------------------------------


def test_compile_cache_dir_from_environment():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert backend.compile_cache_dir(env) == "/some/cache"


def test_compile_cache_dir_fixed_in_checkout():
    path = pathlib.Path(backend.compile_cache_dir({}))
    assert path == ROOT / ".jax_cache"
    # a fixed name, listed in .gitignore so the cache is never committed
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_nothing_when_env_set(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/cache")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == "/env/cache"
    assert calls == []


def test_enable_compile_cache_uses_checkout_path_when_unset(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = backend.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)]
    assert path == str(ROOT / ".jax_cache")


# ---- no fallback that hides the device ------------------------------------


def test_mesh_larger_than_backend_raises():
    """A mesh that does not fit the default backend is an error; the
    trainer never moves to another platform's devices."""
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.base import SVDFeatureTrainer

    tr = SVDFeatureTrainer(SVDTypeParam())
    for n, v in dict(
        num_user=10, num_item=10, num_factor=4, mesh_data=len(jax.devices()),
        mesh_model=2,
    ).items():
        tr.set_param(n, str(v))
    tr.init_model()
    with pytest.raises(ValueError, match="exceeds"):
        tr.init_trainer()


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repo prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ---- card-only -------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_capability_row_on_the_card(gpu):
    assert backend.capabilities() == backend.capabilities_for("gpu")


@pytest.mark.gpu
def test_f32_products_keep_full_precision_on_the_card(gpu):
    """The training path's products run at HIGHEST: a k=64 contraction
    of f32 values agrees with float64 to f32 rounding, where TF32 would
    leave an error near 1e-3 relative."""
    from svdfeature_tpu.ops.embed import _gather_sum

    rng = np.random.RandomState(0)
    tab = rng.randn(1000, 64).astype(np.float32)
    idx = rng.randint(0, 1000, (512, 3)).astype(np.int32)
    val = rng.rand(512, 3).astype(np.float32)
    got = np.asarray(_gather_sum(jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(val)))
    want = np.einsum("bs,bsk->bk", val.astype(np.float64), tab[idx].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
