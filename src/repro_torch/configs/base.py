"""Model / shape configuration system.

One frozen dataclass covers every assigned architecture family (dense,
GQA/MQA, SWA, MoE, RWKV6, RG-LRU hybrid, encoder-decoder, VLM/audio stubs).
Counterpart of the JAX package's ``repro/configs/base.py``, copied whole so
configurations carry over field for field; the port reads neither
``attn_impl`` nor ``pallas_interpret`` (its kernels are chosen by the device
a tensor lies on).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # width of the shared-expert block
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "decoder"            # 'decoder' | 'encdec'
    head_dim: int = 0                  # 0 -> d_model // n_heads
    norm_eps: float = 1e-5
    norm: str = "rms"                  # 'rms' | 'ln'
    rope_theta: float = 10000.0
    rope_frac: float = 1.0             # chatglm applies RoPE to half the dims
    qkv_bias: bool = False
    window: int = 0                    # 0 = full attention; >0 = SWA width
    mlp_act: str = "swiglu"            # 'swiglu' | 'geglu' | 'gelu'
    rms_offset: float = 0.0            # gemma RMSNorm uses (1 + w)
    embed_scale: bool = False          # gemma scales embeddings by sqrt(d)
    tie_embeddings: bool = True
    moe: Optional[MoECfg] = None
    # repeating block-type unit; layer i gets block_pattern[i % len]
    block_pattern: Tuple[str, ...] = ("attn",)   # 'attn' | 'rglru' | 'rwkv'
    local_window: int = 2048           # window of 'attn' blocks in hybrids
    conv1d_width: int = 4              # RG-LRU temporal conv
    rglru_d: int = 0                   # recurrence width (0 -> d_model)
    # encoder (whisper); encoder is bidirectional, decoder cross-attends
    enc_layers: int = 0
    frontend: str = ""                 # '' | 'audio' | 'vision'  (stubs)
    causal: bool = True
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 1024             # KV chunk for the streaming softmax
    attn_impl: str = "xla"             # "xla" | "pallas" (TPU kernel)
    pallas_interpret: bool = False     # CPU validation of the kernel
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 (= pod·data·model worst case)
        so embedding/head shard evenly; pad logits are masked to -inf in the
        LM head (standard MaxText-style practice)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def kv_groups(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def block_type(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    @property
    def attention_free(self) -> bool:
        return all(b in ("rglru", "rwkv") for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode shape?  True when no block
        attends over unbounded history (SWA/local windows are bounded)."""
        has_full_attn = any(
            self.block_type(i) == "attn" and self.window == 0
            and len(self.block_pattern) == 1
            for i in range(self.n_layers)
        )
        if len(self.block_pattern) > 1:
            # hybrid: 'attn' blocks use local_window (bounded)
            has_full_attn = False
        return not has_full_attn or self.window > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family twin for CPU smoke tests: tiny dims, same block
    structure / attention flavour / MoE routing shape."""
    pat_len = len(cfg.block_pattern)
    moe = None
    if cfg.moe is not None:
        moe = MoECfg(
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=32,
            n_shared=min(1, cfg.moe.n_shared),
            d_ff_shared=32 if cfg.moe.n_shared else 0,
            capacity_factor=cfg.moe.capacity_factor,
        )
    heads = 4
    kv = max(1, heads // min(cfg.kv_groups, heads))   # preserve GQA/MQA ratio
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, pat_len),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        moe=moe,
        enc_layers=2 if cfg.enc_layers else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        local_window=16,
        rglru_d=0,
        attn_chunk=32,
        dtype="float32",
    )
