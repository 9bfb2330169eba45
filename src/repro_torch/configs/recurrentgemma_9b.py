"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv1d_size=4,
    attn_window=2048,            # local attention window
    norm="rms",
    act="gelu",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    sub_quadratic=True,          # bounded state: LRU + 2048-token window
))
