"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + shared expert, early fusion (stub frontend).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    moe=True,
    n_experts=16,
    experts_per_tok=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    norm="rms",
    act="silu",
    mlp_kind="swiglu",
    rope_theta=500000.0,
    frontend="vision",           # early-fusion image stub
    frontend_seq=576,
    sub_quadratic=False,
))
