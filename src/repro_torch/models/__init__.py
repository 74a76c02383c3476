"""Model zoo: the shared layers, attention, the decoder-only transformer
(``smollm-135m``'s prefill and KV-cache decode), the GCN (``gcn``:
``gcn-cora``'s aggregations as bag sums) and the recsys models (DLRM RM2,
DCN-v2, SASRec, MIND)."""

from repro_torch.models import attention, layers, transformer

__all__ = ["attention", "layers", "transformer"]
