"""Backend capabilities and the compile cache, decided once per process.

Every solver that picks a form by backend asks ``capabilities()``; none
matches device strings.  The table is keyed on the platform JAX
computes on (``jax.devices()[0].platform``).  An unknown platform is an
error, not a default.

The questions the table answers:

- ``onehot_scatter``: do small tables (<= ops/embed.ONEHOT_THRESHOLD
  rows) gather and scatter through [B, N] one-hot matmuls, or through
  ``.at[].add`` / ``segment_sum``?  The scatter form won on the H100
  (PERF.md, "one-hot vs scatter"); the CPU scatters natively.
- ``accelerator``: is an accelerator behind the process?  The
  multi-round pair dispatch (solvers/svdpp.py) and the GBRT device tree
  walk (solvers/gbrt/trainer.py) pay off only there, and only there does
  the mesh pick the big-slab layout (parallel/mesh_big.py) by itself
  once a shard holds more than ONEHOT_THRESHOLD rows.  The CPU keeps the
  per-round pair path, which replays the exact numpy sampling stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
from typing import Mapping, Optional

import jax


@dataclasses.dataclass(frozen=True)
class Capabilities:
    platform: str
    onehot_scatter: bool
    accelerator: bool


CAPABILITIES = {
    "cpu": Capabilities("cpu", onehot_scatter=False, accelerator=False),
    "gpu": Capabilities("gpu", onehot_scatter=False, accelerator=True),
}

_detected: Optional[Capabilities] = None
_override: Optional[Capabilities] = None


def capabilities_for(platform: str) -> Capabilities:
    try:
        return CAPABILITIES[platform]
    except KeyError:
        raise RuntimeError(
            f"no backend capabilities for platform {platform!r} "
            f"(known: {sorted(CAPABILITIES)})"
        ) from None


def capabilities() -> Capabilities:
    """The capability row of the default backend (decided on first use)."""
    global _detected
    if _override is not None:
        return _override
    if _detected is None:
        _detected = capabilities_for(jax.devices()[0].platform)
    return _detected


@contextlib.contextmanager
def override(**fields):
    """Replace capability fields while the block runs (tests, A/B runs).

    Forms are chosen while JAX traces, so traced programs are dropped on
    entry and on exit; otherwise a cached trace would keep the old form.
    """
    global _override
    prev = _override
    _override = dataclasses.replace(capabilities(), **fields)
    jax.clear_caches()
    try:
        yield _override
    finally:
        _override = prev
        jax.clear_caches()


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints them (one
    line per card).  A card set below its maximum power limit runs
    slower under load, so every device number is reported beside it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---- persistent compile cache ------------------------------------------

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else ``<checkout>/.jax_cache``.

    The path is part of the cache key, so it is fixed: never a temporary
    name, a process id or a time."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it by itself and
    nothing is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
