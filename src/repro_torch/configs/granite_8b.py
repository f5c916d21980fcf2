"""granite-8b — IBM Granite Code 8B [arXiv:2405.04324; hf].

Dense llama-arch: 36L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 49152, swiglu MLP.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, mlp="swiglu", rope_theta=10000.0,
)
