"""Flash attention carrying the fused ABFT chain-checksum column."""
