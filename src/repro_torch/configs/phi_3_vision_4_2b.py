"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    norm="rms",
    act="silu",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    frontend="vision",          # CLIP patch embeddings provided by input_specs
    frontend_seq=576,           # 24x24 patches (stubbed modality frontend)
    sub_quadratic=False,
))
