"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-1b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    norm="rms",
    act="silu",
    mlp_kind="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    sub_quadratic=False,
))
