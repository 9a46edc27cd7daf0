"""Tiled matrix product with the fused ABFT checksum epilogue."""
