"""gemma-2b [dense]: 18L, d=2048, 8H (MQA kv=1), head_dim=256, GeGLU
ff=16384, vocab 256000.  Embeddings scaled by sqrt(d); RMSNorm (1+w).
[arXiv:2403.08295]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    embed_scale=True,
    tie_embeddings=True,
))
