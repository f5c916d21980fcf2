"""smollm-135m — HuggingFaceTB/SmolLM-135M [hf].

Dense llama-arch small: 30L, d_model 576, 9 heads (GQA kv=3), d_ff 1536,
vocab 49152.  Also the end-to-end training-example model.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, mlp="swiglu", rope_theta=10000.0,
    tie_embeddings=True,
)
