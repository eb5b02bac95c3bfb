"""Process-level switches of the port, read from the environment.

The port has its own prefix, ``REPRO_TORCH_``: the reference's
``repro/kernels/dispatch.resolve`` raises on a backend name it does not
know, so a shared ``REPRO_KERNEL_BACKEND=cuda`` would break the JAX package
in the same process.  An explicit argument wins over the variable.
"""

from __future__ import annotations

import os

ENV_KERNEL_BACKEND = "REPRO_TORCH_KERNEL_BACKEND"  # kernels/dispatch.py
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"            # kernels/_build.py


def env_str(name: str) -> str | None:
    v = os.environ.get(name, "").strip()
    return v or None

