"""recurrentgemma-9b — Griffin-style hybrid [arXiv:2402.19427; unverified].

38L, d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000.
RG-LRU + local attention, pattern 1 local-attn per 2 recurrent blocks
(rec, rec, attn).  Sub-quadratic: runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, mlp="swiglu",
    block_pattern=("rec", "rec", "attn"), local_window=2048,
    lru_width=4096, conv_width=4, head_dim=256,
)
