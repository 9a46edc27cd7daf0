"""Checksum algebra, ABFT checks, the GCN model and the synthetic datasets."""
