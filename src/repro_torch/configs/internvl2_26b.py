"""internvl2-26b — InternVL2 26B [arXiv:2404.16821; hf].

VLM: InternViT frontend (STUB: input_specs provides 256 precomputed patch
embeddings per image) + InternLM2-20B-style backbone: 48L, d_model 6144,
48 heads (GQA kv=8), d_ff 16384, vocab 92553.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, mlp="swiglu", rope_theta=1000000.0,
    vision_tokens=256,
)
