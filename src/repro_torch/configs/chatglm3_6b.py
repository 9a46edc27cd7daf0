"""chatglm3-6b [dense]: 28L, d=4096, 32H (GQA kv=2), ff=13696, vocab 65024.
2d (half-dim) RoPE, QKV bias, SwiGLU.  [arXiv:2406.12793]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_frac=0.5,          # ChatGLM rotates half the head dims
    qkv_bias=True,
    mlp_act="swiglu",
    tie_embeddings=False,
))
