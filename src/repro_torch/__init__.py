"""PowerWalk in PyTorch: offline walk-fingerprint index + online VERD serving.

The counterpart of :mod:`repro` (JAX) for NVIDIA Hopper.  Layout mirrors the
JAX package (``core/``, ``graphs/``, ``kernels/``, ``serving/``,
``launch/``); the hot kernels (``walk_step``, ``frontier_push``,
``index_combine_sparse``) are hand-written CUDA C++ built at first use.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` to run the plain PyTorch versions of every kernel.
"""

from repro_torch.device import resolve_device  # noqa: F401
