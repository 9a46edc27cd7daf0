"""recurrentgemma-9b [hybrid]: 38L, d=4096, 16H (MQA kv=1), ff=12288,
vocab 256000.  Griffin pattern: (RG-LRU, RG-LRU, local-attn) repeating,
local window 2048.  [arXiv:2402.19427]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    mlp_act="geglu",
    embed_scale=True,
    tie_embeddings=True,
))
