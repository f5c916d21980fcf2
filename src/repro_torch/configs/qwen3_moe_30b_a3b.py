"""qwen3-moe-30b-a3b — Qwen/Qwen3-30B-A3B [hf].

MoE: 48L, d_model 2048, 32 heads (GQA kv=4), per-expert d_ff 768,
vocab 151936, 128 experts top-8.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, mlp="swiglu", rope_theta=1000000.0,
    n_experts=128, top_k=8, head_dim=128,
)
