"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, sliding-window 4096, LayerNorm + gelu MLP.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    mlp_kind="gelu_mlp",
    rope_theta=100000.0,
    attn_window=4096,
    tie_embeddings=True,
    sub_quadratic=False,
))
