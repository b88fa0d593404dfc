"""Dtype drift: no float leaks into the quantized serving stream.

Counterpart of ``repro/analysis/dtype_drift.py``, over the ops a
``record.Recorder`` wrote down instead of a jaxpr's equations.  The
numerics contract is the reference's: the serving stream computes in the
model dtype (bf16) with explicitly bounded float32 islands (softmax
statistics, dequant scales, the optimizer), and every int8/int4 value is
made by a real quantizer (round and clip against a calibrated threshold),
never by a bare cast.

``drift.promote``
    A binary elementwise aten op whose output is a wider float than one of
    its float operands that has one or more dimensions: an implicit
    promotion (a bf16 residual + a float32 attention output -> a float32
    residual).  Entering float32 through an explicit ``.float()`` / ``.to``
    is sanctioned; widening through arithmetic is drift.  A 0-d operand
    (a scalar such as the softmax scale) is torch's counterpart of jnp's
    weakly typed scalar and does not count.

``drift.raw-int-cast``
    A float -> int8/uint8 conversion (``_to_copy``, or a ``copy_`` into an
    int8 tensor) with no ``round`` among the last ``record.MAX_DEPTH``
    producers of its source: a value entered the quantized domain without
    passing through a quantizer.

``drift.collective``
    A recorded collective moving a float payload.  The interconnect
    contract is quantized bytes: int32 accumulators on the tensor-parallel
    reduces.  The sanctioned float collectives are declarative
    :class:`AllowRule` entries.

``check_integer_all_reduces`` is the rule of the reference's
``launch/hlo_analysis.py`` over the recorded all-reduces: integer payloads
only, but for one float scalar (``compressed_psum``'s shared threshold).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.analysis.report import Finding

# elementwise binary aten ops (in-place forms too) where an implicit
# promotion can smuggle a wide dtype into a narrow stream
_BINARY_ELEMENTWISE = ("add", "sub", "rsub", "mul", "div", "true_divide",
                       "maximum", "minimum", "remainder", "fmod", "pow",
                       "atan2")
# the conversions a dispatch mode sees (``.to`` / ``.type`` reach it as
# ``_to_copy``), and which tensor input is their source
_CONVERSIONS = {"_to_copy": 0, "copy_": 1}
_FLOAT_WIDTH = {torch.bfloat16: 1, torch.float16: 1, torch.float32: 2,
                torch.float64: 3}
_INT8 = (torch.int8, torch.uint8)


@dataclasses.dataclass(frozen=True)
class AllowRule:
    """One declarative exemption.  ``scope`` substring-matches any function
    name on the record's stack; ``primitive`` pins the op (an aten op's
    name, or a collective's kind); ``max_elems`` bounds the value's size (a
    one-scalar exemption cannot grow into a tensor-sized hole).  ``note`` is
    the documented contract: an allowlist entry is documentation."""
    code: str
    note: str
    primitive: Optional[str] = None
    scope: Optional[str] = None
    max_elems: Optional[int] = None

    def matches(self, code: str, rec, n_elems: int) -> bool:
        if code != self.code:
            return False
        if self.primitive is not None and rec.primitive != self.primitive:
            return False
        if self.max_elems is not None and n_elems > self.max_elems:
            return False
        if self.scope is not None:
            if not any(self.scope in n for n in rec.names):
                return False
        return True


DEFAULT_ALLOWLIST: tuple[AllowRule, ...] = (
    # dist/collectives.py::compressed_psum: a float payload shares ONE
    # max-abs threshold across the shards, a float32 scalar max (the group
    # form's ReduceOp.MAX, the one-process form's stand-in); the payload's
    # sum itself is int32
    AllowRule(
        code="drift.collective", primitive="all_reduce",
        scope="compressed_psum", max_elems=1,
        note="compressed_psum shared-scale scalar: one float32 max "
             "establishes the common int8 threshold; payload bytes stay "
             "int8/int32 (dist/collectives.py contract)"),
    # shard/partial_softmax.py: sequence-parallel decode merges the shards'
    # float32 (acc, m, l) flash partials; gathers, not reductions, of
    # B * KV * G * (D + 2) floats a shard, far below the S-sized K/V stream
    # the split avoids moving
    AllowRule(
        code="drift.collective", primitive="all_gather",
        scope="sp_partial_combine",
        note="sequence-parallel partial-softmax merge (one process): float32 "
             "(acc, m, l) partials gather across shards; exact by the "
             "online-softmax identity (shard/partial_softmax.py)"),
    AllowRule(
        code="drift.collective", primitive="all_gather",
        scope="rank_decode_attention",
        note="sequence-parallel partial-softmax merge (rank mesh): each rank "
             "all-gathers the packed float32 (acc, m, l) partials "
             "(shard/partial_softmax.py)"),
    # float32 islands for implicit promotion, scoped to the code that owns
    # them; written with explicit converts today (dormant rules), but part
    # of the documented numerics contract
    AllowRule(code="drift.promote", scope="softmax",
              note="softmax statistics island: max/exp/normalize runs "
                   "float32 regardless of the stream dtype"),
    AllowRule(code="drift.promote", scope="adam_update",
              note="optimizer island: moments and updates are float32 over "
                   "bf16 params by design"),
)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _allowed(allowlist: Sequence[AllowRule], code: str, rec,
             n_elems: int) -> bool:
    return any(r.matches(code, rec, n_elems) for r in allowlist)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_dtype_drift(rec, *, entry_point: str = "",
                      allowlist: Sequence[AllowRule] = DEFAULT_ALLOWLIST,
                      ) -> list[Finding]:
    """The three drift checks over a ``Recorder``'s ops and collectives."""
    findings: list[Finding] = []
    for op in rec.ops:
        base = op.op.rstrip("_") if op.op not in _CONVERSIONS else op.op
        if base in _BINARY_ELEMENTWISE and op.outputs:
            out_dt, out_shape = op.outputs[0]
            out_w = _FLOAT_WIDTH.get(out_dt)
            if out_w is None:
                continue
            narrow = [dt for dt, shape in op.inputs
                      if len(shape) >= 1
                      and _FLOAT_WIDTH.get(dt, out_w) < out_w]
            if not narrow:
                continue
            n = _numel(out_shape)
            if _allowed(allowlist, "drift.promote", op, n):
                continue
            findings.append(Finding(
                analyzer="dtype_drift", code="drift.promote",
                entry_point=entry_point, location=op.location,
                message=f"'{op.op}' implicitly promotes {_name(narrow[0])} "
                        f"to {_name(out_dt)} (shape {out_shape}): a wide "
                        "value entered the narrow stream through arithmetic "
                        "instead of an explicit convert: cast the wide "
                        "operand back to the stream dtype, or the narrow "
                        "one up explicitly"))
        elif op.op in _CONVERSIONS and op.outputs:
            if op.outputs[0][0] not in _INT8:
                continue
            i = _CONVERSIONS[op.op]
            if i >= len(op.inputs):
                continue
            src_dt, src_shape = op.inputs[i]
            if src_dt not in _FLOAT_WIDTH:
                continue        # int -> int repacks are not quantization
            if op.round_hops[i] is not None:
                continue
            n = _numel(src_shape)
            if _allowed(allowlist, "drift.raw-int-cast", op, n):
                continue
            findings.append(Finding(
                analyzer="dtype_drift", code="drift.raw-int-cast",
                entry_point=entry_point, location=op.location,
                message=f"{_name(src_dt)} value (shape {src_shape}) cast "
                        f"straight to {_name(op.outputs[0][0])} with no "
                        "round() upstream: values enter the quantized "
                        "domain only through a quantizer "
                        "(clamp(round(x * scale)).to(int8))"))
    for c in rec.collectives:
        if c.dtype not in _FLOAT_WIDTH:
            continue
        if _allowed(allowlist, "drift.collective", c, c.numel):
            continue
        findings.append(Finding(
            analyzer="dtype_drift", code="drift.collective",
            entry_point=entry_point, location=c.location,
            message=f"collective '{c.kind}' ({c.op}) moves {_name(c.dtype)} "
                    f"payload ({c.numel} elems a shard): the interconnect "
                    "contract is quantized bytes: compress the payload "
                    "(dist/collectives.py::compressed_psum) or add a scoped "
                    "AllowRule stating why this collective must stay float"))
    return findings


def all_reduce_payloads(collectives) -> list[tuple]:
    """Every recorded all-reduce's payload as (dtype name, elements)."""
    return [(_name(c.dtype), c.numel) for c in collectives
            if c.kind == "all_reduce"]


def check_integer_all_reduces(collectives, *, allow_f32_scalars: int = 1):
    """(ok, findings): every all-reduce payload is an integer, but up to
    ``allow_f32_scalars`` one-element float payloads (``compressed_psum``'s
    shared threshold); a float tensor payload always fails (the reference's
    ``launch/hlo_analysis.py::check_integer_all_reduces``)."""
    findings = []
    scalars_seen = 0
    for dtype, elems in all_reduce_payloads(collectives):
        if not getattr(torch, dtype).is_floating_point:
            continue
        if elems <= 1 and scalars_seen < allow_f32_scalars:
            scalars_seen += 1
            continue
        findings.append(
            f"all-reduce moves {dtype}[{elems}]: serving-path reduces must "
            "carry integer payloads (route them through "
            "dist/collectives.py::compressed_psum)")
    return (not findings), findings
