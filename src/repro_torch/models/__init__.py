"""Transformer model components for guarded LM serving (attention decoders)."""
