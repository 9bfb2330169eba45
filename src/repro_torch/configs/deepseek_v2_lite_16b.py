"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]

Layer 1 keeps a dense FFN (d_ff 10944), layers 2..27 are MoE with expert
width 1408, as in the hf config.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                  # dense-FFN width (first_k_dense layer)
    vocab=102400,
    moe=True,
    n_experts=64,
    experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    norm="rms",
    act="silu",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    sub_quadratic=False,
))
