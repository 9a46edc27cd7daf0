"""internvl2-26b [vlm]: InternLM2-20b backbone: 48L, d=6144, 48H (GQA kv=8),
ff=16384, vocab 92553.  InternViT frontend is a STUB: the caller supplies
patch embeddings [B, P, d] as ``prefix_embeds``, prepended to the token
stream.  [arXiv:2404.16821]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    mlp_act="swiglu",
    frontend="vision",
    tie_embeddings=False,
))
