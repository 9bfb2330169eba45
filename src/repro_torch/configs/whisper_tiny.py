"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="encdec",
    source="arXiv:2212.04356",
    n_layers=4,                  # decoder layers
    enc_layers=4,
    is_encdec=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    mlp_kind="gelu_mlp",
    use_rope=False,              # learned positional embeddings
    frontend="audio",            # conv frontend stubbed: frame embeddings in
    frontend_seq=1500,           # 30 s of audio at 50 Hz after conv stride
    tie_embeddings=True,
    sub_quadratic=False,
))
