"""RecSys models: DCN-v2, DLRM RM2, SASRec, MIND and the shared embedding
substrate."""
