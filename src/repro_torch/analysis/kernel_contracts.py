"""Kernel contracts: the hand-written kernels' launch and C-interface
invariants.

Counterpart of ``repro/analysis/pallas_contracts.py``.  The reference
checks its ``pallas_call`` equations and the kernels' Python sources; the
port checks the kernel-wrapper calls a ``record.Recorder`` wrote down and
the ``ctypes`` bindings of the CUDA sources.

**Run pass** (``check_kernel_calls``), over the recorded calls:

``kernel.int4-packing``
    An int8 KV operand (a dense stream or a page pool) of an attention
    kernel is D bytes wide at ``kv_bits=8`` and D/2 (packed nibbles) at
    ``kv_bits=4``, D the query's head dim: the reference's ``dp = D/2``
    rule.

``kernel.operands``
    B3's K agrees with ``w_q``'s rows (K/2 at ``w_bits=4``) and its scales
    have length N (the int32-accumulator branch: ``x_q``'s K with ``w_q``'s
    rows, a contraction range inside K); B1, B2 and B4 get a head dim of at
    most ``D_MAX``, one scale per KV head, and ``q_start`` / ``kv_len`` /
    ``cur_pos`` as int32 of length B on the query's device; every operand
    the wrapper hands to ``ctypes`` as a pointer is contiguous (B4's dense
    K/V may be a slice along S of a contiguous cache, read through its row
    pitch; B5's thresholds are copied contiguous by its wrapper).

``kernel.plain-on-card``
    A wrapper given CUDA tensors ran its plain version outside
    ``kernels.ops.plain_versions()`` (the reference's ``pallas.interpret``:
    a kernel that quietly runs another route than the device's).

``kernel.launch-count``
    An entry point's kernel calls, or (on the card) the launch counters'
    delta around it, differ from the counts its structure implies
    (``expected_launches``): B3 7 x L per pass over the token positions (5
    x L and B3's int32-accumulator branch 2 x tp x L under tp; 4 x L and
    3 x E x L expert products on a mixture-of-experts stack of E experts),
    B2 L per prefill pass, chunk or verify window, B1 L per decode step, B4
    sp x L per sequence-parallel decode step, and the int4, bf16 and
    float32 variants' counters on their variants (B2 over a bf16 or a
    float32 cache, B3's float32 output: a float32 config's experts).

**Source pass** (``check_kernel_sources``), with no card needed:

``kernel.c-arity``
    Each ``extern "C" int repro_*`` entry of ``csrc/*.cu`` and the
    ``argtypes`` list its wrapper hands ``kernels/build.py::function``
    agree in count and, position by position, in kind (pointer, int,
    float); a C entry with no binding, or a binding with no entry, is a
    finding too.  A mismatch corrupts a launch silently.

``kernel.module-registry``
    Every module under ``kernels/`` that binds a C entry
    (``build.function``) is registered in ``kernels.ops.KERNELS``.

``kernel.plain-version``
    Every registered kernel has its plain version ``<name>_ref`` in
    ``kernels/ref.py``.

The reference's Pallas-only rules have no counterpart:
``pallas.block-divide`` (the CUDA kernels mask their ragged edges; the
edge cases are ``chip_smoke.py``'s), ``pallas.interpret-threading`` (the
route is the tensors' device, not a flag threaded through the call) and
``pallas.static-capture`` (a C kernel has no closure; what a captured step
bakes in is ``budgets``' ``capture.host-read``).
"""
from __future__ import annotations

import ast
import re
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from repro_torch.analysis.report import Finding

ATTENTION = ("decode_attention", "decode_attention_partials",
             "prefill_attention")
# operands a wrapper copies before the launch, and B4's in-place S slices
_COPIED = {("fake_quant", "t_max"), ("fake_quant", "alpha")}
_PITCHED = {("decode_attention_partials", "k"),
            ("decode_attention_partials", "v")}
_VECTORS = ("q_start", "kv_len", "cur_pos")
# launch counters that count no kernel's launches
_NOT_LAUNCHES = {("compressed_psum", "wire_bytes")}


def _finding(code, message, entry_point, location=""):
    return Finding(analyzer="kernel_contracts", code=code, message=message,
                   entry_point=entry_point, location=location)


# ---------------------------------------------------------------------------
# run pass
# ---------------------------------------------------------------------------

def _d_max(kernel: str) -> int:
    from repro_torch.kernels import decode_attention, prefill_attention

    mod = prefill_attention if kernel == "prefill_attention" else \
        decode_attention
    return mod.D_MAX


def _rows_contiguous(o) -> bool:
    """A (B, S, KV, dp) operand whose positions are contiguous rows."""
    if len(o.shape) != 4:
        return False
    _, _, kvh, dp = o.shape
    return (o.stride[3] == 1 and o.stride[2] == dp
            and o.stride[1] == kvh * dp)


def _quant_matmul_operands(kc) -> list[str]:
    ops_, bad = kc.operands, []
    if kc.attrs.get("acc"):
        x, w = ops_["x_q"], ops_["w_q"]
        k = x.shape[-1]
        if w.shape[0] != k:
            bad.append(f"x_q has K={k} but w_q has {w.shape[0]} rows")
        k0, k1 = kc.attrs.get("k0", 0), kc.attrs.get("k1", k)
        if not 0 <= k0 <= k1 <= k:
            bad.append(f"contraction range [{k0}, {k1}) is not inside "
                       f"K={k}")
        out = ops_.get("out")
        if out is not None and (out.dtype != torch.int32
                                or out.shape != (x.shape[0], w.shape[1])):
            bad.append(f"out is {out.dtype} {out.shape}, not int32 "
                       f"({x.shape[0]}, {w.shape[1]})")
        return bad
    x, w, s = ops_["x"], ops_["w_q"], ops_["w_scale"]
    k = x.shape[-1]
    rows = k // 2 if kc.attrs.get("w_bits") == 4 else k
    if w.shape[0] != rows:
        bad.append(f"x has K={k} but w_q has {w.shape[0]} rows (want "
                   f"{rows} at w_bits={kc.attrs.get('w_bits')})")
    if s.shape != (w.shape[-1],):
        bad.append(f"w_scale is {s.shape}, not one scale per output column "
                   f"({w.shape[-1]},)")
    if ops_["act_scale"].numel != 1:
        bad.append(f"act_scale has {ops_['act_scale'].numel} values, not 1")
    return bad


def _attention_operands(kc) -> list[str]:
    ops_, bad = kc.operands, []
    q = ops_["q"]
    b, d = q.shape[0], q.shape[-1]
    kvh = q.shape[2] if kc.kernel == "prefill_attention" else q.shape[1]
    if d > _d_max(kc.kernel):
        bad.append(f"head dim {d} exceeds D_MAX={_d_max(kc.kernel)}")
    for name in ("k_scale", "v_scale"):
        if ops_[name].shape != (kvh,):
            bad.append(f"{name} is {ops_[name].shape}, not one scale per "
                       f"KV head ({kvh},)")
    for name in _VECTORS:
        vec = ops_.get(name)
        if vec is None:
            continue
        if (vec.dtype != torch.int32 or vec.shape != (b,)
                or vec.device != q.device):
            bad.append(f"{name} is {vec.dtype} {vec.shape} on {vec.device},"
                       f" not int32 ({b},) on {q.device}")
    return bad


def _contiguity(kc) -> list[str]:
    bad = []
    for name, o in kc.operands.items():
        if o.contiguous or (kc.kernel, name) in _COPIED:
            continue
        if (kc.kernel, name) in _PITCHED and not kc.paged \
                and _rows_contiguous(o):
            continue
        bad.append(f"{name} {o.shape} with strides {o.stride} is not "
                   "contiguous")
    return bad


def _packing(kc) -> Optional[str]:
    k = kc.operands.get("k")
    if k is None or k.dtype != torch.int8:
        return None
    d = kc.operands["q"].shape[-1]
    bits = kc.attrs.get("kv_bits", 8)
    want = d // 2 if bits == 4 else d
    if k.shape[-1] == want and (bits == 8 or d % 2 == 0):
        return None
    return (f"KV operand is {k.shape[-1]} bytes wide against a query head "
            f"dim of {d} at kv_bits={bits}: storage width must be D (int8) "
            "or D/2 (packed int4 nibbles)")


def check_kernel_calls(calls, *, entry_point: str = "") -> list[Finding]:
    """The run pass over recorded ``KernelCall``s (a Recorder's
    ``kernels``)."""
    findings: list[Finding] = []
    for kc in calls:
        if kc.device == "cuda" and not kc.launched and not kc.attrs.get(
                "twin"):
            findings.append(_finding(
                "kernel.plain-on-card",
                f"{kc.kernel} ran its plain version on CUDA tensors outside "
                "kernels.ops.plain_versions(): the card's path must launch "
                "the hand-written kernel", entry_point, kc.location))
        if kc.kernel in ATTENTION:
            msg = _packing(kc)
            if msg:
                findings.append(_finding("kernel.int4-packing",
                                         f"{kc.kernel}: {msg}", entry_point,
                                         kc.location))
            bad = _attention_operands(kc)
        elif kc.kernel == "quant_matmul":
            bad = _quant_matmul_operands(kc)
        else:
            bad = []
        bad += _contiguity(kc)
        if bad:
            findings.append(_finding(
                "kernel.operands", f"{kc.kernel}: " + "; ".join(bad),
                entry_point, kc.location))
    return findings


def launch_keys(kc) -> list[tuple]:
    """The launch counters (``kernels.ops.COUNTERS`` keys) a call advances
    when it launches: the counters of the kernel module it reaches."""
    k = kc.kernel
    if k == "quant_matmul":
        if kc.attrs.get("acc"):
            return [(k, "launches_acc")]
        return [(k, "launches")] + (
            [(k, "launches_w4")] if kc.attrs.get("w_bits") == 4 else []) + (
            [(k, "launches_f32")] if kc.attrs.get("out_f32") else [])
    if k not in ATTENTION:
        return [(k, "launches")]
    keys = [(k, "launches")]
    if kc.attrs.get("kv_bits") == 4:
        keys.append((k, "launches_int4"))
    if kc.paged:
        keys.append((k, "launches_paged"))
    if k == "prefill_attention":
        if kc.operands["k"].dtype == torch.bfloat16:
            keys.append((k, "launches_bf16"))
        if kc.operands["k"].dtype == torch.float32:
            keys.append((k, "launches_f32"))
        if kc.attrs.get("window") is not None:
            keys.append((k, "launches_window"))
    return keys


def recorded_launches(rec) -> dict:
    """The launch counters a recorded run advances on the card: its kernel
    calls by counter, and ``compressed_psum``'s reduces (one sum-reduce
    collective each)."""
    n = Counter()
    for kc in rec.kernels:
        for key in launch_keys(kc):
            n[key] += 1
    n[("compressed_psum", "reduces")] += sum(
        1 for c in rec.collectives if c.kind == "all_reduce"
        and c.op == "sum")
    return {k: v for k, v in n.items() if v}


def expected_launches(n_layers: int, kind: str, passes: int, *,
                      tp: int = 1, sp: int = 1, kv_bits: int = 8,
                      kv_float: bool = False, f32: bool = False,
                      int8: bool = True, projections: int = 7,
                      experts: int = 0, row_parallel: int = 2,
                      readout: bool = False, paged: bool = False) -> dict:
    """The launch counters ``passes`` passes of kind "prefill" (a prompt or
    one chunk of it), "decode" (one token) or "verify" (one speculative
    window) over ``n_layers`` attention layers (no window, no experts)
    advance: B3 once per quantized projection (``projections`` a layer;
    under tp its ``row_parallel`` ones through the int32-accumulator
    branch, once per shard, and one reduce each) and three times per
    expert (``experts`` a layer: gate, up and down, each expert launched
    whether or not it got tokens; through B3's float32 output where ``f32``,
    a float32 config), and once per readout
    where the readout is a quantized ``lm_head`` (``readout``: once per
    prefill, chunked or not, and once per decode step or verify window);
    and the layer's attention kernel: B2 for a prefill pass (its bf16
    branch over a float cache, its float32 one over a float32 cache:
    ``kv_float`` and ``f32``) and for a verify window over a quantized
    cache, B1 for a decode step over a quantized cache (B4 once per
    sequence shard), nothing where the attention is plain (a float cache's
    decode and verify, a sequence-parallel prefill or verify); ``paged``:
    the attention reads a page pool through its block table (a chunk, a
    decode step or a verify window over a paged cache)."""
    n = Counter()
    per = n_layers * passes
    if int8:
        heads = int(readout) * (1 if kind == "prefill" else passes)
        if tp > 1:
            n[("quant_matmul", "launches")] = (projections - row_parallel) \
                * per + heads
            n[("quant_matmul", "launches_acc")] = row_parallel * tp * per
            n[("compressed_psum", "reduces")] = row_parallel * per
        else:
            n[("quant_matmul", "launches")] = (projections + 3 * experts) \
                * per + heads
            if f32:
                n[("quant_matmul", "launches_f32")] = 3 * experts * per
    attn = None
    if kind == "prefill" and sp == 1:
        attn = "prefill_attention"
    elif kind == "decode" and not kv_float:
        attn = "decode_attention" if sp == 1 else "decode_attention_partials"
    elif kind == "verify" and sp == 1 and not kv_float:
        attn = "prefill_attention"
    if attn is not None:
        m = per * (sp if attn == "decode_attention_partials" else 1)
        n[(attn, "launches")] = m
        if paged:
            n[(attn, "launches_paged")] = m
        if kv_float:
            n[(attn, "launches_f32" if f32 else "launches_bf16")] = m
        elif kv_bits == 4:
            n[(attn, "launches_int4")] = m
    return {k: v for k, v in n.items() if v}


def check_launch_counts(rec, expected: dict, *, launched: Optional[dict] = None,
                        entry_point: str = "") -> list[Finding]:
    """``kernel.launch-count``: the recorded calls (and ``launched``, the
    launch counters' delta on the card) against ``expected``."""
    findings = []
    got = {"calls": recorded_launches(rec)}
    if launched is not None:
        got["launches on the card"] = {k: v for k, v in launched.items()
                                       if k not in _NOT_LAUNCHES}
    for what, counts in got.items():
        if counts != expected:
            keys = sorted(set(counts) | set(expected))
            diff = ", ".join(f"{k[0]}.{k[1]} {counts.get(k, 0)} (want "
                             f"{expected.get(k, 0)})" for k in keys
                             if counts.get(k, 0) != expected.get(k, 0))
            findings.append(_finding(
                "kernel.launch-count",
                f"the {what} differ from the counts the entry point's "
                f"structure implies: {diff}", entry_point))
    return findings


# ---------------------------------------------------------------------------
# source pass
# ---------------------------------------------------------------------------

_C_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(repro_\w+)\s*\(([^)]*)\)',
                      re.S)
_CTYPES_KIND = {"c_void_p": "pointer", "c_char_p": "pointer",
                "c_float": "float", "c_double": "float"}


def _c_kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    if re.match(r"(const\s+)?(float|double)\b", param.strip()):
        return "float"
    return "int"


def c_entries(csrc_dir) -> dict:
    """{symbol: ([kinds], "file:line")} of every ``extern "C" int repro_*``
    in ``csrc_dir``'s ``.cu`` files."""
    out = {}
    for cu in sorted(Path(csrc_dir).glob("*.cu")):
        text = cu.read_text()
        for m in _C_ENTRY.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            line = text.count("\n", 0, m.start()) + 1
            out[m.group(1)] = ([_c_kind(p) for p in params],
                               f"csrc/{cu.name}:{line}")
    return out


def _ctypes_kind(node, names: dict) -> str:
    if isinstance(node, ast.Name):
        node = names.get(node.id, node)
    attr = node.attr if isinstance(node, ast.Attribute) else \
        getattr(node, "id", "?")
    if attr in _CTYPES_KIND:
        return _CTYPES_KIND[attr]
    return "int" if attr.startswith(("c_int", "c_uint", "c_long",
                                     "c_size", "c_short")) else f"?{attr}"


def _aliases(fn) -> dict:
    """{name: ctypes node} from ``p, i = ctypes.c_void_p, ctypes.c_int`` /
    ``p = ctypes.c_void_p`` assignments in ``fn``."""
    names = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Tuple) and isinstance(node.value,
                                                         ast.Tuple):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name):
                        names[t.id] = v
            elif isinstance(tgt, ast.Name):
                names[tgt.id] = node.value
    return names


def _is_bind(call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "function"
            and isinstance(f.value, ast.Name) and f.value.id == "build")


def bindings(kernels_dir) -> list[tuple]:
    """(module stem, symbol, [kinds], "file:line") of every
    ``build.function(lib, "repro_*", [argtypes])`` in ``kernels_dir``."""
    out = []
    for py in sorted(Path(kernels_dir).glob("*.py")):
        tree = ast.parse(py.read_text())
        scopes = [n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.Module))]
        seen = set()
        for scope in scopes:
            names = _aliases(scope)
            for call in ast.walk(scope):
                if not (isinstance(call, ast.Call) and _is_bind(call)) or \
                        id(call) in seen or len(call.args) < 3:
                    continue
                seen.add(id(call))
                sym = call.args[1]
                argt = call.args[2]
                if not (isinstance(sym, ast.Constant)
                        and isinstance(argt, (ast.List, ast.Tuple))):
                    continue
                out.append((py.stem, sym.value,
                            [_ctypes_kind(e, names) for e in argt.elts],
                            f"kernels/{py.name}:{call.lineno}"))
    return out


def check_kernel_sources(kernels_dir: Optional[str] = None,
                         csrc_dir: Optional[str] = None) -> list[Finding]:
    """The source pass over the kernel wrappers' bindings and the CUDA
    sources (the package's own by default)."""
    from repro_torch.kernels import ops, ref

    pkg = Path(ops.__file__).parent
    kernels_dir = Path(kernels_dir) if kernels_dir else pkg
    csrc_dir = Path(csrc_dir) if csrc_dir else pkg.parent / "csrc"
    findings: list[Finding] = []
    entries = c_entries(csrc_dir)
    binds = bindings(kernels_dir)
    bound = set()
    for stem, sym, kinds, loc in binds:
        bound.add(sym)
        if sym not in entries:
            findings.append(_finding(
                "kernel.c-arity", f"{loc} binds {sym}, which no "
                f"extern \"C\" entry of {csrc_dir.name}/*.cu defines", "",
                loc))
            continue
        want, where = entries[sym]
        if kinds != want:
            if len(kinds) != len(want):
                what = f"{len(kinds)} argtypes for {len(want)} parameters"
            else:
                what = "; ".join(f"argument {i}: {got} for a {c} parameter"
                                 for i, (got, c) in enumerate(zip(kinds,
                                                                  want))
                                 if got != c)
            findings.append(_finding(
                "kernel.c-arity", f"{sym}: the binding at {loc} disagrees "
                f"with its C entry at {where}: {what}", "", loc))
    for sym, (_, where) in sorted(entries.items()):
        if sym not in bound:
            findings.append(_finding(
                "kernel.c-arity", f"{sym} ({where}) has no ctypes binding "
                f"in {kernels_dir.name}/", "", where))
    registered = {m.__name__.rsplit(".", 1)[-1] for m in ops.KERNELS.values()}
    for stem in sorted({b[0] for b in binds} - registered):
        findings.append(_finding(
            "kernel.module-registry",
            f"kernels/{stem}.py binds a CUDA entry but is not registered in "
            "kernels.ops.KERNELS: register it so its launches are counted "
            "and its contracts checked", "", f"kernels/{stem}.py"))
    for name in sorted(ops.KERNELS):
        if not callable(getattr(ref, f"{name}_ref", None)):
            findings.append(_finding(
                "kernel.plain-version",
                f"registered kernel {name} has no plain version "
                f"{name}_ref in kernels/ref.py", "", "kernels/ref.py"))
    return findings
