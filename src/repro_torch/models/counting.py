"""Analytic parameter counts per architecture (total and active), used by
the roofline's MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference) terms.
Port of ``repro.models.counting``."""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.mla:
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim)
        return (d * h * (dn + dr) + d * r + d * dr
                + r * h * (dn + dv) + h * dv * d)
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _mlp_params(cfg, f=None) -> int:
    f = cfg.d_ff if f is None else f
    return (3 if cfg.mlp_kind == "swiglu" else 2) * cfg.d_model * f


def _moe_params(cfg, active: bool) -> tuple[int, int]:
    d, fe = cfg.d_model, cfg.moe_d_ff
    routed = cfg.experts_per_tok if active else cfg.n_experts
    total = cfg.d_model * cfg.n_experts              # router
    total += routed * 3 * d * fe
    total += cfg.n_shared_experts * 3 * d * fe
    return total, total


def _rec_params(cfg) -> int:
    d, w = cfg.d_model, cfg.lru_width
    return 2 * d * w + 2 * w * w + w * d + cfg.conv1d_size * w


def _ssm_params(cfg) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.ssm_state
    return d * (2 * di + 2 * cfg.ssm_state + nh) + di * d \
        + cfg.conv1d_size * conv_dim


def layer_params(cfg, kind: str, active: bool) -> int:
    if kind == "attn":
        return _attn_params(cfg) + _mlp_params(cfg)
    if kind == "moe":
        moe, _ = _moe_params(cfg, active)
        return _attn_params(cfg) + moe
    if kind == "rec":
        return _rec_params(cfg) + _mlp_params(cfg)
    if kind == "ssm":
        return _ssm_params(cfg)
    raise ValueError(kind)


def param_count(cfg, active: bool = False) -> int:
    """Total (or per-token active) parameter count."""
    n = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model
    for kind in cfg.pattern():
        n += layer_params(cfg, kind, active)
    if cfg.is_encdec:
        for _ in range(cfg.enc_layers):
            n += _attn_params(cfg) + _mlp_params(cfg)
        # per-decoder-layer cross attention
        n += cfg.n_layers * _attn_params(cfg)
    return n


def model_flops(cfg, tokens: int, kind: str) -> float:
    """MODEL_FLOPS per the assignment's definition: 6*N*D for training,
    2*N*D for inference forward (N = active params for MoE)."""
    n_active = param_count(cfg, active=True)
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active * tokens
