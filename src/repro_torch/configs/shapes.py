"""Assigned input-shape cells and per-arch applicability.

LM transformer shapes are seq_len x global_batch. ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a seq_len KV/state cache),
NOT ``train_step``. ``long_500k`` needs sub-quadratic attention: it runs
for SSM/hybrid archs only (skips recorded in DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# Archs whose unbounded-context layers are O(1)-state (SSM/hybrid):
# the only ones for which long_500k is a realisable configuration.
SUBQUADRATIC = {"rwkv6-3b", "jamba-v0.1-52b"}


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def cells(archs: list[str]) -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells, in stable order."""
    return [(a, s) for a in archs for s in SHAPES
            if applicable(a, s)]
