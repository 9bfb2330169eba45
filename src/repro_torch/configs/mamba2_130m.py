"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,                   # attention-free
    n_kv_heads=0,
    d_ff=0,                      # the SSD mixer has no separate MLP
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,                # d_inner = 1536
    ssm_chunk=256,
    conv1d_size=4,
    norm="rms",
    tie_embeddings=True,
    sub_quadratic=True,          # constant-size SSM state
))
