"""The one place that maps the JAX platform to the engines that run on it.

``platform()`` probes JAX once; :data:`ENGINES` says, per platform, which
fill engine each path takes when the caller leaves the choice to "auto",
and whether protein corpora build their score tables on the device from
code vectors (the codes path).  A platform missing from the table is an
error, and so is a JAX backend that fails to start: nothing falls back to
another engine behind the caller's back.  Only when ``jax`` itself cannot
be imported do lone pairs run on the host engines.
"""

from __future__ import annotations

# platform -> path -> (engine, widest max_shift it takes); wider bands run
# the XLA scan.  On the GPU the CUDA kernel holds every path where it
# measured faster end to end than the XLA scan (PERF.md): lone pairs up to
# max_shift 1 (one thread block per pair cannot beat XLA's whole-card
# diagonal steps on a lone ms2 pair) and every corpus path.  "codes":
# protein corpora build their score tables on the device.
ENGINES = {
    "gpu": {"pair": ("cuda", 1), "batch": ("cuda", 2), "codes": True},
    "cpu": {"pair": ("xla", None), "batch": ("xla", None), "codes": False},
}


def platform() -> str | None:
    """The default JAX device's platform, or None when jax is not
    installed.  Errors from starting a backend propagate."""
    try:
        import jax
    except ImportError:
        return None
    return jax.devices()[0].platform


def choice(key: str, plat: str | None = None):
    """The :data:`ENGINES` entry ``key`` for ``plat`` (default: the
    probed platform)."""
    plat = platform() if plat is None else plat
    try:
        return ENGINES[plat][key]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {plat!r}: bialign runs on "
            f"{sorted(ENGINES)}"
        ) from None


def _engine(path: str, max_shift: int, plat: str | None) -> str:
    engine, widest = choice(path, plat)
    if widest is not None and int(max_shift) > widest:
        return "xla"
    return engine


def pair_engine(max_shift: int, plat: str | None = None) -> str:
    """Engine for ``engine="auto"`` lone pairs: the table's choice for
    this band width, or the host C++ engine (the numpy oracle without a
    compiler) when jax is not installed."""
    if plat is None and platform() is None:
        from .ops import native_dp

        return "native" if native_dp.available() else "numpy"
    return _engine("pair", max_shift, plat)


def batch_engine(engine: str, max_shift: int,
                 plat: str | None = None) -> str:
    """Resolve a corpus path's ``engine`` argument ("auto", "xla" or
    "cuda") to the engine that runs."""
    from .ops import cuda_dp

    if engine == "auto":
        engine = _engine("batch", max_shift, plat)
    if engine not in ("xla", "cuda"):
        raise ValueError(f"unknown batch engine {engine!r}")
    if engine == "cuda" and not cuda_dp.supports(max_shift):
        raise ValueError(
            f"engine='cuda' covers max_shift <= {cuda_dp.MAX_SHIFT}"
        )
    return engine
