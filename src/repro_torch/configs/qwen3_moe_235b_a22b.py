"""qwen3-moe-235b-a22b — Qwen3-235B-A22B-style [hf:Qwen/Qwen3-30B-A3B].

MoE: 94L, d_model 4096, 64 heads (GQA kv=4), per-expert d_ff 1536,
vocab 151936, 128 experts top-8.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, mlp="swiglu", rope_theta=1000000.0,
    n_experts=128, top_k=8, head_dim=128,
)
