"""whisper-medium [audio]: 24L enc + 24L dec, d=1024, 16H (kv=16), ff=4096,
vocab 51865.  Conv/mel frontend is a STUB: the caller supplies precomputed
frame embeddings [B, S, d] as ``src_embeds``.  [arXiv:2212.04356]"""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_act="gelu",
    norm="ln",
    rope_frac=0.0,          # whisper uses absolute positions (sinusoid here)
    qkv_bias=True,
    tie_embeddings=True,
    frontend="audio",
))
