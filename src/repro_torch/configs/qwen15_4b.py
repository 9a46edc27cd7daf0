"""qwen1.5-4b [dense]: 40L, d=2560, 20H (MHA kv=20), ff=6912, vocab 151936.
QKV bias.  [hf:Qwen/Qwen1.5-*]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    mlp_act="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
))
