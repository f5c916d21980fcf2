"""nemotron-4-340b — NVIDIA Nemotron-4 340B [arXiv:2402.16819; unverified].

Dense GQA with squared-ReLU MLP: 96L, d_model 18432, 96 heads (kv=8),
d_ff 73728, vocab 256000.  At this size Adam fp32 state cannot fit a
single 256-chip v5e pod; the config selects adafactor (documented in
EXPERIMENTS.md §Dry-run).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, mlp="squared_relu", rope_theta=10000.0,
    optimizer="adafactor",
)
