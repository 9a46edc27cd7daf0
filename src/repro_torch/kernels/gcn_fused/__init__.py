"""One GCN-ABFT layer S (H W) in a single sweep."""
