"""Device resolution shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA request without a GPU raises.

    The entry points default to ``"cuda"`` so a missing card is an error,
    never a silent fall back to the CPU: the plain PyTorch paths run only
    when the caller asks for ``device="cpu"``.
    """
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return d
