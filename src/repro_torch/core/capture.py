"""One CUDA graph per dispatch shape: the whole top-k query as one launch.

The port's counterpart of the reference's ``jax.jit`` over
``_fused_topk_impl`` (``repro.core.query``), whose cache holds one entry
per padded width.  A :class:`CapturedQuery` records the eager query
(iterate, combine, top-k: the same hand-written kernels and PyTorch ops
the eager path launches) into a ``torch.cuda.CUDAGraph`` over static
tensors:

* inputs: the sources (``int32[W]`` or seed sets ``int32[W, S]``), their
  weights (``f32[W, S]``) and, in the ``mcfp`` mode, the step key words
  (``int64[steps, 3, 2]``, ``core.walks.step_key_words``), which a caller
  writes before each :meth:`CapturedQuery.replay`;
* outputs: ``f32[W, k]`` and ``int32[W, k]``, written by the graph's last
  two copies and overwritten by its next replay.

Before the capture the query runs once eagerly on a side stream, on copies
of the inputs: that builds the views the kernels read, which are cached on
their owners (``Graph.col_sorted``, ``Graph.ell``, ``PPRIndex.columns``,
the engine's degree cap) and cannot be built inside a capture; loads the
kernel libraries; makes each kernel's once-per-process set-up; and gives
``kernels.ops.capture_first_launches`` arguments that no replay
overwrites.  Every graph of an engine allocates from the engine's one
memory pool (``torch.cuda.graph_pool_handle``): the graphs replay one at a
time on one stream, so their scratch may overlap, while their outputs are
tensors allocated outside the pool.  A failed capture raises; nothing
falls back to the eager path.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import ops

Body = Callable[[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]],
                Tuple[torch.Tensor, torch.Tensor]]


class CapturedQuery:
    """The query ``body(sources, weights, words) -> (values, indices)`` of
    one dispatch shape captured as a CUDA graph over the static inputs
    ``sources``, ``weights`` and ``words`` (None where the query takes
    none), which hold the first dispatch's values when it is built."""

    def __init__(self, body: Body, sources: torch.Tensor,
                 weights: Optional[torch.Tensor],
                 words: Optional[torch.Tensor], top_k: int, pool):
        t0 = time.perf_counter()
        dev = sources.device
        self.sources, self.weights, self.words = sources, weights, words
        inputs = (sources, weights, words)
        q = int(sources.shape[0])
        self.values = torch.empty((q, top_k), dtype=torch.float32, device=dev)
        self.indices = torch.empty((q, top_k), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(*(None if x is None else x.clone() for x in inputs))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with ops.recording_launches() as launches:
            with torch.cuda.graph(self.graph, pool=pool):
                vals, idx = body(*inputs)
                self.values.copy_(vals)
                self.indices.copy_(idx)
        self.launches = dict(launches)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch the graph on the current stream; returns the static
        outputs, valid until the next replay is enqueued."""
        self.graph.replay()
        ops.add_replayed_launches(self.launches)
        return self.values, self.indices


def pool_bytes(pool, device) -> Optional[int]:
    """Bytes of the device segments the memory pool ``pool`` holds (from
    ``torch.cuda.memory_snapshot``), or None where the snapshot does not
    name each segment's pool."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        named = True
        if seg.get("device") == idx and tuple(pid) == tuple(pool):
            total += int(seg["total_size"])
    return total if named else None
