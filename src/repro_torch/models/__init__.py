"""Model zoo: the shared layers, attention, and the recsys models' serving
(DLRM RM2, DCN-v2, SASRec, MIND)."""
