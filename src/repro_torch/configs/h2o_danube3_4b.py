"""h2o-danube-3-4b [dense]: 24L, d=3840, 32H (GQA kv=8), ff=10240,
vocab 32000.  Llama+Mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    window=4096,            # mistral-style SWA -> bounded cache, runs 500k
    mlp_act="swiglu",
    tie_embeddings=False,
))
