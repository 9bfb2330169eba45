"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch code model. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    norm="rms",
    act="silu",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    sub_quadratic=False,
))
