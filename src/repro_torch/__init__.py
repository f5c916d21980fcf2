"""PyTorch/CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

Module names follow the JAX package (``configs``, ``kernels``, ``models``,
``serve``, ``launch``) so each counterpart is easy to find.  This package
imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on CUDA unless the caller asks for the CPU: with no card
present and no CPU request they raise (``resolve_device``) instead of
quietly running on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' (--device cpu) to run on the CPU")
    return dev
