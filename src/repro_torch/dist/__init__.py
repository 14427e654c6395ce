"""Distributed-execution primitives for the port: logical-axis sharding,
fault tolerance, and elastic mesh reconfiguration (the JAX package's
``dist``).

Layers:
  * :mod:`repro_torch.dist.api` — ``constrain`` / ``constrain_weight`` /
    ``use_sharding``, specs as DTensor placements, and ``place``. Every
    constraint is a no-op when no sharding context is active, so
    single-device paths run unchanged.
  * :mod:`repro_torch.dist.sharding` — the ``_PARAM_RULES`` path-pattern
    table plus param/batch/cache layout builders.
  * :mod:`repro_torch.dist.fault` — straggler monitoring, failure
    injection, restart supervision (host-side; a copy of the JAX
    package's).
  * :mod:`repro_torch.dist.elastic` — checkpoint restore onto a different
    (shrunk/grown) mesh.
"""
import importlib

# ``api`` imports torch.distributed; it loads at a name's first use, so
# ``fault`` (host-side, what the control plane needs) imports without it.
_API = ("ShardingContext", "constrain", "constrain_weight", "current", "use_sharding")


def __getattr__(name: str):
    if name not in _API:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.api"), name)
