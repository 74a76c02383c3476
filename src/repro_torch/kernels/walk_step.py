"""``walk_step``: the offline walk engine's bulk cursor advance.

:func:`walk_step_plain` is the plain PyTorch version (the CPU path and the
oracle on the card); :func:`walk_step_cuda` launches ``csrc/walk_step.cu``.
Callers go through :func:`repro_torch.kernels.ops.walk_step`, which picks
by device and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]


def sample_edge_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Edge offset ``floor(u * deg)`` clipped to ``[0, deg - 1]`` — the one
    sampling law of the walk engine, this kernel and its plain version
    (``walks.sample_edge_offsets`` in the reference)."""
    off = torch.floor(u * deg.to(torch.float32)).to(torch.int32)
    return torch.minimum(torch.clamp(off, min=0), torch.clamp(deg - 1, min=0))


def walk_sources(cursors: torch.Tensor,
                 sources: torch.Tensor) -> torch.Tensor:
    """``sources`` broadcast to ``cursors``' shape: it holds one source per
    walk (the cursors' shape) or one per row (``cursors.shape[:-1]``, a
    trailing 1 allowed)."""
    if sources.shape == cursors.shape:
        return sources
    return sources.reshape(cursors.shape[:-1] + (1,)).expand(cursors.shape)


def walk_step_plain(cursors, sources, u, row_ptr, out_deg, col_idx):
    """next = deg == 0 ? source : col_idx[clip(start + clip(floor(u * deg),
    0, deg - 1), 0, m - 1)] for every walk (any shape; ``sources`` as
    :func:`walk_sources` takes them)."""
    cur = cursors.long()
    deg = out_deg[cur]
    start = row_ptr[cur]
    m = col_idx.shape[0]
    addr = torch.clamp(start + sample_edge_offsets(u, deg), 0, m - 1)
    home = walk_sources(cursors, sources).to(torch.int32)
    return torch.where(deg == 0, home, col_idx[addr.long()])


def walk_step_cuda(cursors, sources, u, row_ptr, out_deg, col_idx):
    """Launch the CUDA kernel on the current stream (no sync)."""
    dev = cursors.device
    for name, t, dt in (
        ("cursors", cursors, torch.int32), ("sources", sources, torch.int32),
        ("u", u, torch.float32), ("row_ptr", row_ptr, torch.int32),
        ("out_deg", out_deg, torch.int32), ("col_idx", col_idx, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"walk_step: {name} must be a contiguous {dt} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
    if u.shape != cursors.shape or sources.shape not in (
            cursors.shape, cursors.shape[:-1]):
        raise ValueError("walk_step: u must have the cursors' shape, sources "
                         "that shape or one entry per row")
    m = col_idx.shape[0]
    if m == 0 or m >= 2 ** 31:
        raise ValueError(f"walk_step: needs 0 < m < 2**31 edges, got {m}")
    out = torch.empty_like(cursors)
    lib = build.load("walk_step")
    fn = lib.walk_step_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        cursors.data_ptr(), sources.data_ptr(), u.data_ptr(),
        row_ptr.data_ptr(), out_deg.data_ptr(), col_idx.data_ptr(),
        out.data_ptr(), cursors.numel(),
        cursors.numel() // max(sources.numel(), 1), m,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "walk_step")
    return out


# ---------------------------------------------------------------------------
# Contract-auditor entry point (repro_torch.analysis): col_idx reaches the
# kernel as the graph's own global memory, only gathered from, and no
# block's shared memory depends on the graph (hbm-residency).
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _contract_spec_walk_step(device):
    import numpy as np

    from repro_torch.graphs import synthetic
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    n, w = 4096, 256
    g = synthetic.erdos_renyi(n, 5.0, seed=13, device=device)
    cur = torch.as_tensor(rng.integers(0, n, w), dtype=torch.int32,
                          device=g.device)
    src = torch.as_tensor(rng.integers(0, n, w), dtype=torch.int32,
                          device=g.device)
    u = torch.as_tensor(rng.random(w), dtype=torch.float32, device=g.device)
    return dict(
        kernel="walk_step", fn=ops.walk_step,
        args=(cur, src, u, g.row_ptr, g.out_deg, g.col_idx),
        operands={"col_idx": 5},
        hbm_shapes=[(g.m,)],
        dynamic_smem=lambda lib, args, kwargs: {"walk_step_kernel": 0},
    )


_register_ep("walk-step", "hbm-residency",
             "src/repro_torch/kernels/walk_step.py", _contract_spec_walk_step)
