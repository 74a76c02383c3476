"""Model zoo: the recsys models ported so far (DLRM RM2 serving)."""
