"""whisper-medium — OpenAI Whisper medium [arXiv:2212.04356; unverified].

Enc-dec audio: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(kv=16, i.e. MHA), d_ff 4096, vocab 51865.  Conv frontend is a STUB:
input_specs provides precomputed frame embeddings (seq_len frames).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, mlp="gelu", encoder_layers=24,
    rope_theta=0.0,   # whisper uses sinusoid/learned positions, not RoPE
)
