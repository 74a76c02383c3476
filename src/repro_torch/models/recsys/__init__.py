"""RecSys models: DLRM RM2 and the shared embedding substrate."""
