"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig``; every workload shape is a
``ShapeConfig``.  ``(arch, shape)`` cells drive the smoke tests, the
multi-pod dry-run and the roofline table.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | squared_relu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (RG-LRU + local attention)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_window: int = 0
    lru_width: int = 0
    conv_width: int = 4
    # ssm (rwkv6)
    rwkv_head_dim: int = 64
    # vlm stub frontend
    vision_tokens: int = 0           # precomputed patch embeddings per sample
    # enc-dec (whisper): encoder stack + cross attention, frame-embed stub
    encoder_layers: int = 0
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    # attention backend: 'xla' (chunked online-softmax jnp; used for
    # lowering/roofline so FLOPs are visible in HLO) or 'pallas'
    attention_impl: str = "xla"
    attn_chunk: int = 1024
    # serving KV-cache dtype: 'model' (= cfg.dtype) or 'int8'
    # (per-(position, kv-head) symmetric quantization — halves cache HBM
    # and the decode memory roofline; beyond-paper serving optimization)
    kv_cache_dtype: str = "model"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with a bounded cache at 500k context?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline cross-checks)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        def attn_p():
            return d * H * hd + 2 * d * KV * hd + H * hd * d
        def mlp_p(ff):
            n = 3 if self.mlp == "swiglu" else 2
            return n * d * ff
        total = V * d + (0 if self.tie_embeddings else V * d) + d
        if self.family == "ssm":                      # rwkv6
            per = (4 * d * d + d * d          # r,k,v,g + output
                   + 2 * d                    # decay/bonus etc (approx)
                   + 2 * d * f // 2 + d * f   # channel mix (approx)
                   + 8 * d)
            # channel-mix in rwkv6: wk (d,f) wv (f,d) wr (d,d)
            per = 5 * d * d + d * f + f * d + 10 * d
            return total + L * per
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec",)
            n_attn = L * pat.count("attn") // len(pat)
            n_rec = L - n_attn
            w = self.lru_width or d
            rec = (d * w * 2                      # in/gate proj
                   + self.conv_width * w          # conv
                   + 2 * w * (w // 16 if False else 1) * 0
                   + 2 * w * w // max(1, 1)       # placeholder
                   + w * d)
            rec = 2 * d * w + self.conv_width * w + 3 * w + w * d \
                + 2 * (w * w) // 16               # block-diag gates (16 blocks)
            per_mlp = mlp_p(f)
            return total + n_attn * (attn_p() + per_mlp + 2 * d) \
                + n_rec * (rec + per_mlp + 2 * d)
        per = attn_p() + 2 * d
        if self.n_experts:
            per += d * self.n_experts \
                + self.n_experts * mlp_p(f) // 1
        else:
            per += mlp_p(f)
        total += L * per
        if self.encoder_layers:
            enc_per = attn_p() + mlp_p(f) + 2 * d
            dec_cross = attn_p() + d
            total += self.encoder_layers * enc_per + L * dec_cross
        if self.vision_tokens:
            total += self.vision_tokens * 0  # frontend is a stub
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        n = 3 if self.mlp == "swiglu" else 2
        expert_p = n * d * f
        total = self.param_count() - L * self.n_experts * expert_p
        return total + L * self.top_k * expert_p


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip policy (DESIGN.md §4): long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "skip(full-attn)"
    return True, ""


def smoke_variant(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, len(arch.block_pattern) or 2),
        d_model=64, n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 2),
        d_ff=128, vocab=256, head_dim=16,
        dtype="float32", param_dtype="float32", remat=False,
        attn_chunk=32,
    )
    if arch.n_experts:
        kw.update(n_experts=8, top_k=2, d_ff=32)
    if arch.family == "hybrid":
        kw.update(lru_width=64, local_window=32,
                  n_layers=len(arch.block_pattern))
    if arch.family == "ssm":
        kw.update(rwkv_head_dim=16, d_ff=128)
    if arch.encoder_layers:
        kw.update(encoder_layers=2)
    if arch.vision_tokens:
        kw.update(vision_tokens=8)
    return replace(arch, **kw)
