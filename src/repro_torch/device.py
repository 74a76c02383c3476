"""Device resolution shared by every entry point."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA request without a GPU raises.

    The entry points default to ``"cuda"`` so a missing card is an error,
    never a silent fall back to the CPU: the plain PyTorch paths run only
    when the caller asks for ``device="cpu"``.  ``"meta"`` is admitted as
    a device that computes nothing: its tensors carry shapes and dtypes
    only, which is what the dry-run (``launch/dryrun.py``) traces.
    """
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if d.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or meta)")
    return d


def seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for draws on ``device``.  The meta
    device has no generator of its own and draws nothing, so its draws take
    a CPU generator; a caller that makes tensors on ``gen.device`` makes
    them on the CPU then, unless the dry-run's factory mode sends them to
    meta (``launch/dryrun.py``)."""
    dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=dev).manual_seed(seed)


class OnMeta(TorchFunctionMode):
    """Every tensor a factory function makes inside goes to ``meta``,
    whatever device its call names: an ``init`` draws from a CPU generator
    on meta (:func:`seeded_generator`) and allocates nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)
