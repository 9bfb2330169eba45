"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric",        # OLMo's non-parametric LN
    act="silu",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    sub_quadratic=False,
))
