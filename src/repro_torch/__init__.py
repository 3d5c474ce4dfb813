"""PyTorch port of the dense CAPre tensor-store server.

It mirrors the layout of the JAX package ``repro`` (``configs/``,
``models/``, ``kernels/``, ``launch/``, ``core/``, ``apps/``,
``runtime/``, ``predict/``, ``obs/``, ...) so that each module's
counterpart is easy to find, but imports nothing of it: what it needs is
copied here.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA device
that is not there raises; nothing drops to the CPU on its own.  On the CPU
(``device="cpu"``) every kernel wrapper runs its plain PyTorch version.
CAPre's analysis of an object-oriented application (``core.lang`` to
``core.lint``, and the benchmark apps in ``apps``), the persistent object
store it prefetches into (``pos``) and the store's predictors
(``predict.static_capre``, ``rop``, ``markov``, ``hybrid``) hold no tensor:
they run on the host and take no device, as their JAX twins do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
