"""The platform table, the compile cache, exactness settings and the chip
smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bialign_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ("GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
       "...(((.....))).....", ".(((.....)))....")


def test_engine_table_gpu():
    """The measured choice: the kernel for lone pairs up to max_shift 1
    and for every corpus path it covers."""
    assert backend.pair_engine(0, plat="gpu") == "cuda"
    assert backend.pair_engine(1, plat="gpu") == "cuda"
    assert backend.pair_engine(2, plat="gpu") == "xla"
    assert backend.batch_engine("auto", 2, plat="gpu") == "cuda"
    assert backend.choice("codes", "gpu") is True


def test_engine_table_cpu():
    assert backend.pair_engine(2, plat="cpu") == "xla"
    assert backend.batch_engine("auto", 2, plat="cpu") == "xla"
    assert backend.choice("codes", "cpu") is False
    # the probe itself: the test tier runs on the CPU
    assert backend.platform() == "cpu"


def test_unknown_platform_is_an_error():
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.pair_engine(1, plat="metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.batch_engine("auto", 1, plat="rocm")


def test_wide_bands_take_the_xla_scan():
    """The kernel covers max_shift <= 2; wider bands run the XLA scan
    under "auto" and refuse an explicit engine="cuda"."""
    assert backend.pair_engine(3, plat="gpu") == "xla"
    assert backend.batch_engine("auto", 3, plat="gpu") == "xla"
    assert backend.batch_engine("auto", 4, plat="gpu") == "xla"
    with pytest.raises(ValueError, match="max_shift"):
        backend.batch_engine("cuda", 3, plat="gpu")
    with pytest.raises(ValueError, match="unknown batch engine"):
        backend.batch_engine("pallas", 1, plat="gpu")


def test_failing_backend_is_not_hidden(monkeypatch):
    """A JAX backend that fails to start raises; nothing falls back to
    the host engines."""
    from bialign_tpu import BiAligner

    def broken():
        raise RuntimeError("backend failed to start")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="failed to start"):
        BiAligner(*TOY, engine="auto", type="RNA")
    with pytest.raises(RuntimeError, match="failed to start"):
        backend.batch_engine("auto", 1)


def test_no_jax_routes_lone_pairs_to_host_engines(monkeypatch):
    from bialign_tpu.ops import native_dp

    monkeypatch.setattr(backend, "platform", lambda: None)
    want = "native" if native_dp.available() else "numpy"
    assert backend.pair_engine(1) == want


def test_unknown_engine_names_raise():
    from bialign_tpu import BiAligner

    with pytest.raises(ValueError, match="unknown engine"):
        BiAligner(*TOY, engine="pallas", type="RNA")


def test_cuda_engine_off_gpu_fails_loudly():
    """engine="cuda" on the CPU raises (no nvcc, or no CPU lowering of
    the kernel): the kernel has no interpret mode to fall back to."""
    from bialign_tpu import BiAligner

    ba = BiAligner(*TOY, engine="cuda", type="RNA", max_shift=1)
    with pytest.raises(Exception):
        ba.optimize()


def _cache_probe(env):
    code = (
        "from bialign_tpu.utils.jaxconfig import ensure_compile_cache\n"
        "ensure_compile_cache()\n"
        "import jax, jax.numpy as jnp\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        f"jax.jit(lambda x: jnp.sin(x) * {os.getpid()}.25)(1.0)"
        ".block_until_ready()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def _env(**kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(kw)
    return env


def test_compile_cache_follows_env_var(tmp_path):
    cache = tmp_path / "cache"
    got = _cache_probe(_env(JAX_COMPILATION_CACHE_DIR=str(cache)))
    assert got == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_defaults_inside_checkout():
    from bialign_tpu.utils.jaxconfig import DEFAULT_CACHE_DIR

    assert os.path.dirname(DEFAULT_CACHE_DIR) == REPO
    got = _cache_probe(_env())
    assert got == DEFAULT_CACHE_DIR
    assert os.path.isdir(DEFAULT_CACHE_DIR) and os.listdir(DEFAULT_CACHE_DIR)


def test_lut_contraction_is_full_fp32():
    """The codes path's one-hot LUT contractions ask for
    Precision.HIGHEST (true fp32, not TF32): exact for |LUT| < 2^24."""
    from bialign_tpu.ops.device_tables import mu_planes_from_codes

    B, P, M = 2, 5, 6
    args = (jnp.zeros((256, 256), jnp.int32),
            jnp.zeros((B, P), jnp.uint8), jnp.zeros((B, M), jnp.uint8),
            jnp.zeros((B, P), jnp.uint8), jnp.zeros((B, M), jnp.uint8),
            jnp.full((B,), P - 1, jnp.int32),
            jnp.full((B,), M - 1, jnp.int32))
    jaxpr = jax.make_jaxpr(
        lambda *a: mu_planes_from_codes(*a, 800))(*args)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        prec = e.params["precision"]
        assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec
    # and the contraction is exact at the bound's edge
    lut = np.zeros((256, 256), np.int32)
    lut[65, 66] = (1 << 24) - 1
    ca = np.zeros((1, 3), np.uint8)
    ca[0, 1:] = 65
    cb = np.zeros((1, 3), np.uint8)
    cb[0, 1:] = 66
    mu1, _ = mu_planes_from_codes(
        jnp.asarray(lut), jnp.asarray(ca), jnp.asarray(cb),
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray([2], jnp.int32),
        jnp.asarray([2], jnp.int32), 100)
    assert int(mu1[0, 1, 1]) == (1 << 24) - 1


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _smoke(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
