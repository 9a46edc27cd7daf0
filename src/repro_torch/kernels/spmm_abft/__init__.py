"""Block-ELL SpMM with the fused ABFT checksum epilogue."""
