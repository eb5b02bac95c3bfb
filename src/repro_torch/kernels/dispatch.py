"""Backend resolution for the port's kernels — resolved ONCE per op.

    backend   what runs                                  when
    -------   ----------------------------------------   -------------------
    "cuda"    the hand-written kernel (csrc/*.cu)        CUDA tensors
    "ref"     the plain PyTorch version (kernels/ref.py) CPU tensors
    "auto"    resolve from the device the op will see    the default

``auto`` resolves from the device of the tensors, not from the platform:
a CUDA tensor always goes to the kernel and a CPU tensor always to the
plain version, so no setting can send a CUDA tensor down a plain path or
hand the kernel a CPU tensor.  Asking for a backend that does not match
the device raises.  Selection order: explicit argument >
``ArchConfig.kernel_backend`` (callers pass it through) >
``REPRO_TORCH_KERNEL_BACKEND`` > auto.

The resolved name is only validated: the wrappers (``kernels/tcn_block``,
``proto_extract``, ``log2_matmul``, ``dilated_conv``) branch on each tensor's device themselves, so
a backend setting never changes what runs, it only raises on a mismatch.
"""

from __future__ import annotations

import torch

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
BACKENDS = ("auto", "cuda", "ref")


def resolve(requested: str | None, device) -> str:
    """Resolve a requested backend for ops that will run on ``device``.
    Returns "cuda" or "ref"; raises on an unknown name or a mismatch."""
    # imported here: repro_torch.configs imports the models, which import
    # this module, so a top-level import would make the import order matter
    from repro_torch.configs.runtime import env_str

    req = (requested or "auto").lower()
    env = env_str(ENV_VAR)
    if req == "auto" and env:
        req = env.lower()
    if req not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {req!r}; expected one of {BACKENDS}")
    on_cuda = torch.device(device).type == "cuda"
    if req == "auto":
        return "cuda" if on_cuda else "ref"
    if (req == "cuda") != on_cuda:
        raise ValueError(
            f"kernel backend {req!r} does not run on device {device!r}: "
            "CUDA tensors go to the kernel, CPU tensors to the plain version")
    return req


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no card
    is present (entry points default to "cuda" and never fall back to the
    CPU: the caller asks for it with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
