"""qwen3-moe-30b-a3b [moe]: 48L, d=2048, 32H (GQA kv=4), vocab 151936.
128 experts (ff=768) top-8, no shared expert.  [hf:Qwen/Qwen3-30B-A3B]"""
from . import register
from .base import ModelConfig, MoECfg

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768),
    mlp_act="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
))
