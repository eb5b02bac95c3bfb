"""Runtime configuration: one resolved view of the port's process switches.

The port of ``repro/configs/runtime.py``.  The switches are one frozen
dataclass with one precedence, applied field by field:

    explicit kwarg  >  environment variable  >  default

``RuntimeConfig.resolve(**overrides)`` implements the middle level: a
field passed as a non-None override wins; the rest fall back to the
environment and then to the dataclass default.  A directly constructed
``RuntimeConfig(...)`` is fully explicit and never reads the environment.

The variables carry the port's own prefix, ``REPRO_TORCH_``: the
reference reads ``REPRO_*`` (and its ``kernels/dispatch.resolve`` raises
on a backend name it does not know), so a shared name would switch the
JAX package in the same process.  Truthiness is the reference's: "1",
"true", "yes" (case-insensitive, stripped) are True, any other value
False.  An unset or empty variable leaves the default, which differs from
the reference for one field: ``fused`` defaults to True, so a service on
the card runs the kernels.  ``kernel_backend`` is kept as the raw string
and handed to ``kernels/dispatch.resolve``, which validates it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

# asserted == the owning modules' ENV_VAR constants in
# tests/test_torch_protocol.py (this module imports nothing of the port)
ENV_PAGED = "REPRO_TORCH_PAGED"                      # sessions/lm.py
ENV_FUSED = "REPRO_TORCH_TCN_FUSED"                  # sessions/service.py
ENV_KERNEL_BACKEND = "REPRO_TORCH_KERNEL_BACKEND"    # kernels/dispatch.py
ENV_TRACE = "REPRO_TORCH_TRACE"                      # obs/trace.py
ENV_DEVICE_COUNTERS = "REPRO_TORCH_DEVICE_COUNTERS"  # obs/device.py
ENV_CHAOS = "REPRO_TORCH_CHAOS"                      # serving/faults.py
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"              # kernels/_build.py

_TRUE = ("1", "true", "yes")


def env_str(name: str) -> str | None:
    v = os.environ.get(name, "").strip()
    return v or None


def env_bool(name: str, default: bool = False) -> bool:
    v = env_str(name)
    return default if v is None else v.lower() in _TRUE


@dataclass(frozen=True)
class RuntimeConfig:
    """Resolved process-level switches (precedence in the module docstring).

    paged            LM KV caches use the paged block-pool layout
    fused            TCN streaming runs the fused kernel path (default on)
    kernel_backend   force a kernels/dispatch backend (None = auto)
    trace_path       Perfetto trace output path (None = tracing off); the
                     plane exports its tracer there on close
    device_counters  the tick also returns its occupancy stats
    chaos            fault-injection plan spec (serving/faults.FaultPlan
                     format, e.g. "crash@40,flake@25"); None = no faults
    """

    paged: bool = False
    fused: bool = True
    kernel_backend: str | None = None
    trace_path: str | None = None
    device_counters: bool = False
    chaos: str | None = None

    @classmethod
    def resolve(cls, **overrides) -> "RuntimeConfig":
        """Build a config honouring ``explicit kwarg > env > default``.
        Overrides passed as ``None`` fall through to the environment."""
        unknown = set(overrides) - {f.name for f in fields(cls)}
        if unknown:
            raise TypeError(f"unknown RuntimeConfig fields: {sorted(unknown)}")
        d = cls()
        env = cls(
            paged=env_bool(ENV_PAGED, d.paged),
            fused=env_bool(ENV_FUSED, d.fused),
            kernel_backend=env_str(ENV_KERNEL_BACKEND),
            trace_path=env_str(ENV_TRACE),
            device_counters=env_bool(ENV_DEVICE_COUNTERS, d.device_counters),
            chaos=env_str(ENV_CHAOS),
        )
        picked = {k: (getattr(env, k) if v is None else v)
                  for k, v in overrides.items()}
        return cls(**{f.name: picked.get(f.name, getattr(env, f.name))
                      for f in fields(cls)})

    def pick(self, field: str, explicit):
        """One field through the full precedence: the caller's explicit
        kwarg (non-None) beats this config's value."""
        return getattr(self, field) if explicit is None else explicit
