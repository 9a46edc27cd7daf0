"""deepseek-moe-16b [moe]: 28L, d=2048, 16H (kv=16), vocab 102400.
Fine-grained MoE: 64 routed experts (ff=1408) top-6 + 2 shared experts.
[arXiv:2401.06066]"""
from . import register
from .base import ModelConfig, MoECfg

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408,
               n_shared=2, d_ff_shared=2816),
    mlp_act="swiglu",
    tie_embeddings=False,
))
