"""rwkv6-3b — RWKV-6 'Finch' 3B [arXiv:2404.05892; hf].

Attention-free SSM with data-dependent decay: 32L, d_model 2560,
d_ff 8960, vocab 65536.  Head dim 64 (40 heads).  Sub-quadratic:
runs long_500k with O(1) recurrent state.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, mlp="rwkv", rwkv_head_dim=64,
)
