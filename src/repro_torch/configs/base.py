"""Architecture configuration system (port of ``repro.configs.base``).

Every assigned architecture gets one ``ArchConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves them through the registry.
``reduced()`` produces a same-family tiny config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.accel import ExecSpec, PrecisionPolicy

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    source: str = ""                 # provenance note

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    norm: str = "rms"                # rms | layernorm | nonparametric
    act: str = "silu"                # MLP nonlinearity
    mlp_kind: str = "swiglu"         # swiglu | gelu_mlp
    rope_theta: float = 10000.0
    use_rope: bool = True            # whisper uses learned positions instead
    causal: bool = True              # encoders run bidirectional
    tie_embeddings: bool = False
    attn_window: Optional[int] = None   # sliding local window (None = full)

    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # expert FFN width (d_ff = dense width)
    first_k_dense: int = 0           # leading layers with dense FFN
    moe_capacity_factor: float = 1.25

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # hybrid recurrence (recurrentgemma)
    block_pattern: tuple = ()        # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv1d_size: int = 4

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0

    # modality frontend stub ([vlm]/[audio]: precomputed embeddings)
    frontend: str = "none"           # none | vision | audio
    frontend_seq: int = 0            # stub frontend sequence length

    # paper technique: per-layer execution-backend policy (repro_torch.accel).
    # Default = all-digital; with_accel()/with_policy() route the
    # static-weight projections through a CIM backend.
    policy: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy)

    # runtime
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    sub_quadratic: bool = False      # eligible for long_500k decode

    # perf knobs (§Perf hillclimb; defaults = paper-faithful baseline)
    attn_scan_remat: bool = False    # recompute attn-chunk internals in bwd
    onehot_embed: bool = False       # embedding as one-hot matmul (no gather)
    attn_bf16_probs: bool = False    # bf16 softmax probs into the PV dot
    sp_residual: bool = False        # sequence-parallel residual stream
    # near-memory datapath fusion (paper Figs. 5/8; DESIGN.md §10): MLP /
    # gate activations and the MLP residual ride accel.matmul(post=) as a
    # fused Postreduce epilogue instead of separate post-matmul ops.
    # False = the unfused baseline.
    # Numerics: on quantized backends the epilogue runs on the f32
    # recombined output BEFORE the cast to the activation dtype — the
    # chip's own order (the datapath precedes the DMA) — so bfloat16
    # configs diverge from the unfused act(cast(y)) ordering by per-layer
    # rounding that compounds through the residual stream (float32
    # configs are bit-identical; bf16 fused is no worse an approximation
    # of the f32 model than bf16 unfused — pinned by
    # test_model_fused_no_worse_than_unfused_under_bf16).
    fuse_datapath: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def pattern(self) -> tuple:
        """Per-layer block kinds, length n_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.block_pattern:
            reps = -(-self.n_layers // len(self.block_pattern))
            return (self.block_pattern * reps)[: self.n_layers]
        if self.moe:
            return (("attn",) * self.first_k_dense
                    + ("moe",) * (self.n_layers - self.first_k_dense))
        return ("attn",) * self.n_layers

    def with_accel(self, backend: str = "bpbs", rules=(),
                   **spec_kw) -> "ArchConfig":
        """Uniform execution spec for every managed projection, plus
        optional per-layer ``(pattern, ExecSpec)`` rules on top — e.g.
        ``cfg.with_accel("bpbs", ba=4, bx=4,
        rules=(("path:unembed", ExecSpec(backend="digital")),))``."""
        policy = PrecisionPolicy(rules=tuple(rules),
                                 default=ExecSpec(backend=backend, **spec_kw))
        return dataclasses.replace(self, policy=policy)

    def with_policy(self, policy: PrecisionPolicy) -> "ArchConfig":
        return dataclasses.replace(self, policy=policy)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if not self.block_pattern
                         else max(len(self.block_pattern), 3)),
            d_model=128,
            n_heads=max(4, 1),
            n_kv_heads=0,
            head_dim=32,
            d_ff=256,
            vocab=512,
            moe_d_ff=64 if self.moe else 0,
            n_experts=min(self.n_experts, 8),
            experts_per_tok=min(self.experts_per_tok, 2),
            first_k_dense=min(self.first_k_dense, 1),
            kv_lora_rank=32 if self.mla else 0,
            qk_nope_head_dim=32 if self.mla else 0,
            qk_rope_head_dim=16 if self.mla else 0,
            v_head_dim=32 if self.mla else 0,
            lru_width=128 if self.lru_width else 0,
            ssm_state=32 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            enc_layers=min(self.enc_layers, 2),
            frontend_seq=min(self.frontend_seq, 8) if self.frontend_seq else 0,
            dtype="float32",
            remat=False,
        )
        if self.n_kv_heads:
            # keep the GQA ratio flavour: 4 heads, kv = 1, 2 or 4
            ratio = max(1, self.n_heads // self.n_kv_heads)
            scale["n_kv_heads"] = max(1, 4 // min(ratio, 4))
        return dataclasses.replace(self, **scale)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import ALL_ARCHS  # ensure registration side effects ran

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from . import ALL_ARCHS  # ensure registration side effects ran

    return sorted(_REGISTRY)
