"""Architecture registry + assigned input shapes (the 40-cell matrix); a
copy of ``repro.configs.registry``.

Each ``src/repro_torch/configs/<id>.py`` (a copy of the reference's, value
for value) exports:
  * ``CONFIG`` — the exact assigned architecture,
  * ``SMOKE``  — a reduced same-family config for CPU smoke tests.

Shapes (assignment): train_4k / prefill_32k / decode_32k / long_500k.
``long_500k`` requires sub-quadratic attention — it runs only for
rwkv6-3b (ssm) and jamba-1.5-large (hybrid); pure full-attention archs skip
it (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.transformer import ModelConfig

ARCH_IDS = [
    "phi35_moe_42b",
    "granite_moe_1b",
    "rwkv6_3b",
    "llava_next_34b",
    "jamba_15_large_398b",
    "stablelm_12b",
    "llama3_8b",
    "deepseek_coder_33b",
    "yi_34b",
    "whisper_tiny",
]

# Human-facing aliases from the assignment sheet.
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "rwkv6-3b": "rwkv6_3b",
    "llava-next-34b": "llava_next_34b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "stablelm-12b": "stablelm_12b",
    "llama3-8b": "llama3_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-34b": "yi_34b",
    "whisper-tiny": "whisper_tiny",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def get_smoke(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{arch}").SMOKE


def cells(arch: str) -> List[Tuple[str, ShapeSpec]]:
    """All (shape_name, spec) dry-run cells applicable to this arch."""
    cfg = get_config(arch)
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            continue            # full-attention arch: skip (DESIGN.md §5)
        out.append((name, spec))
    return out


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s, _ in cells(a)]
