"""Input-shape cells: (sequence length, global batch) per kind of step.

The port's copy of ``repro/configs/shapes.py``; the training CLI builds
its own ``ShapeSpec("cli", "train", seq, batch)``.

  train_4k     seq 4096,   global batch 256  — training      (train_step)
  prefill_32k  seq 32768,  global batch 32   — inference     (prefill_step)
  decode_32k   seq 32768,  global batch 128  — decode        (serve_step)
  long_500k    seq 524288, global batch 1    — long decode   (serve_step)

``decode_*``/``long_*`` run one new token against a KV cache of seq_len.
``long_500k`` needs sub-quadratic attention: it runs only for the archs
with an SSM or sliding-window component (mamba2, hymba, gemma3, mixtral);
the pure full-attention archs skip it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with a sub-quadratic path (SSM state or sliding-window KV): the
# only ones for which a 512k-token decode cell is defined
SUB_QUADRATIC = {"mamba2-780m", "hymba-1.5b", "gemma3-12b", "mixtral-8x7b"}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(applicable, reason-if-not), the reference's reasons word for
    word."""
    if shape == "long_500k" and arch not in SUB_QUADRATIC:
        return False, (
            "pure full-attention arch: 512k dense-KV decode has no "
            "sub-quadratic path (skip noted in DESIGN.md)"
        )
    return True, ""


def all_cells(archs: list[str]) -> list[tuple[str, str]]:
    """Every applicable (arch, shape) cell, archs outer, shapes inner."""
    return [(a, s) for a in archs for s in SHAPES
            if cell_applicable(a, s)[0]]
