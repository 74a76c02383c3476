"""Config schema: architectures x input shapes.

Every ported architecture gets one module exporting ``full()`` (the
published config), ``reduced()`` (CPU smoke size) and ``SPEC``.
``launch/steps.py`` turns (arch, shape) into init / step callables and
batch specs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell.

    kind:
      lm_train | lm_prefill | lm_decode          (LM family)
      gnn_full | gnn_minibatch | gnn_batched      (GNN family)
      rec_train | rec_serve | rec_retrieval       (RecSys family)
    """

    name: str
    kind: str
    seq_len: int = 0
    global_batch: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An architecture entry in the registry."""

    id: str
    family: str                  # lm | gnn | recsys
    model_kind: str        # transformer | gcn | dcn | dlrm | sasrec | mind
    config: Any                  # model config, full size
    reduced: Any                 # reduced smoke config
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.id} has no shape {name!r}")


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "lm_train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "lm_prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "lm_decode", seq_len=32768, global_batch=128),
    # long-context decode: the serve step is O(S) per token
    ShapeSpec("long_500k", "lm_decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "gnn_full", extra=dict(
        n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec("minibatch_lg", "gnn_minibatch", extra=dict(
        n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, n_classes=41)),
    ShapeSpec("ogb_products", "gnn_full", extra=dict(
        n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    ShapeSpec("molecule", "gnn_batched", extra=dict(
        n_nodes=30, n_edges=64, batch=128, d_feat=32, n_classes=2)),
)

REC_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "rec_train", global_batch=65536),
    ShapeSpec("serve_p99", "rec_serve", global_batch=512),
    ShapeSpec("serve_bulk", "rec_serve", global_batch=262144),
    ShapeSpec("retrieval_cand", "rec_retrieval", global_batch=1,
              extra=dict(n_candidates=1_000_000)),
)
