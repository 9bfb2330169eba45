"""The assigned (architecture x input-shape) grid: 10 archs x 4 shapes.
Port of ``repro.launch.shapes``.

``decode_*`` / ``long_*`` run ``decode_step`` (one token against a
KV/state cache of seq_len), NOT the train step.  ``long_500k`` requires
sub-quadratic attention: it runs for the SSM/hybrid archs (mamba2-130m,
recurrentgemma-9b) and is skipped for the eight full-attention archs
(recorded per cell and in DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str              # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeDef("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeDef("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeDef("long_500k", "decode", 524288, 1),
}

# gradient-accumulation microbatch counts for train_4k (DESIGN.md §6)
TRAIN_MICROBATCHES = {
    "phi-3-vision-4.2b": 4,
    "deepseek-v2-lite-16b": 4,
    "llama4-scout-17b-a16e": 8,
    "recurrentgemma-9b": 8,
    "starcoder2-3b": 4,
    "granite-8b": 8,
    "llama3.2-1b": 2,
    "olmo-1b": 2,
    "mamba2-130m": 1,
    "whisper-tiny": 1,
}


def cell_supported(cfg, shape_name: str) -> tuple[bool, str]:
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: quadratic full-attention arch — a 524k "
                       "dense-KV decode is exactly what this shape excludes "
                       "(DESIGN.md §5)")
    if shape.kind == "decode" and cfg.family == "encoder":
        return False, "skipped: encoder-only arch has no decode step"
    return True, ""


def all_cells():
    from repro_torch.configs import ALL_ARCHS, get_config

    for arch in ALL_ARCHS:
        for shape_name in SHAPES:
            cfg = get_config(arch)
            ok, reason = cell_supported(cfg, shape_name)
            yield arch, shape_name, ok, reason
