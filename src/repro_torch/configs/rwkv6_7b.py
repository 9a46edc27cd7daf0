"""rwkv6-7b [ssm] "Finch": 32L, d=4096, attention-free (data-dependent decay
time-mix), ff=14336 channel-mix, vocab 65536.  [arXiv:2404.05892]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,             # head_size 64
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rope_frac=0.0,
    tie_embeddings=False,
))
