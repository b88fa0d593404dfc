"""The port's meta-device dry run (``repro_torch.launch.dryrun``) against the
reference's compile-only grid (``repro.launch.dryrun``), on the CPU.

The reference side is built once, in one subprocess (this file run as a
script with ``--reference``), on 256 placeholder devices, with the
reference's unscanned trees (``scan_layers=False``: the port unrolls its
layer stack).  Held against it:

* ``cell_applicable`` / ``all_cells`` for all 10 x 4 cells, with the same
  reasons; ``param_count`` / ``active_param_count`` for all 10 archs;
* the param, qparam, batch and cache spec trees leaf by leaf, for every
  arch at SMOKE and for smollm-135m and mixtral-8x7b at full width
  (``jax.eval_shape``: nothing allocated), under the default rules,
  ``multipod``, ``act_seq=None`` and ``kv_cache_layout="seq"``;
* the per-device argument bytes of every cell on 16x16 against the bytes
  of the reference's ``NamedSharding.shard_shape`` (a long_500k cell fails
  on both sides, on its batch of 1 over 16 data devices).

On the port's side alone: the argument bytes on 1x1 against the real
CPU-built trees; the meta trace's counted FLOPs, unfused bytes and peak
live bytes against the same step run on real CPU tensors under the same
counter; smollm-135m SMOKE prefill's FLOPs against closed forms; each
kernel wrapper's meta route against its plain version's shapes and dtypes
(with no plain version run); and ``main(["--all"])`` at SMOKE on 1x1.

Run alone: ``python tests/test_torch_dryrun.py --reference`` prints the
reference's side as JSON; ``--stacked`` prints, per full-width cell on
16x16, the reference's argument bytes with its scanned (stacked) layers
minus those with unrolled ones.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FULL = ("smollm-135m", "mixtral-8x7b")
# the spec trees' batch and cache cells
BATCH_SHAPE = "prefill_32k"
CACHE_B, CACHE_S = 128, 32768


def _key(path) -> str:
    """A key path as one string (qparams keys hold '/' themselves)."""
    return "|".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# The reference's side (run as a script, in a subprocess)
# ---------------------------------------------------------------------------


def _reference_main(stacked: bool) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.tree_util import tree_flatten_with_path

    from repro.configs import ARCHS, SHAPES, all_cells, cell_applicable
    from repro.configs import get_config
    from repro.core import api as A
    from repro.dist import sharding as SH
    from repro.launch import specs as SP
    from repro.launch.mesh import make_production_mesh
    from repro.models import build_model

    P = SH.P
    mesh = make_production_mesh(multi_pod=False)
    is_p = lambda x: isinstance(x, P)  # noqa: E731

    def pk(k):
        return getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))

    def flat_specs(spec_tree):
        leaves, _ = tree_flatten_with_path(spec_tree, is_leaf=is_p)
        return {_key(pk(k) for k in path): json.loads(json.dumps(list(s)))
                for path, s in leaves}

    def dev_bytes(tree, spec_tree):
        spec_leaves = [s for _, s in tree_flatten_with_path(
            spec_tree, is_leaf=is_p)[0]]
        total = 0
        for (_, leaf), spec in zip(tree_flatten_with_path(tree)[0],
                                   spec_leaves):
            shp = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += int(np.prod(shp)) * jnp.dtype(leaf.dtype).itemsize
        return total

    rules_of = {"default": SH.ShardingRules(),
                "multipod": SH.multipod(SH.ShardingRules()),
                "act_seq_none": SH.ShardingRules(act_seq=None),
                "kv_seq": SH.ShardingRules(kv_cache_layout="seq")}

    def cell_bytes(model, cfg, shape, rules):
        """The dry run's argument list of one cell (the decode position, a
        host int in the port, left out), as bytes per device."""
        policy = A.QuantPolicy()
        if shape.kind == "train":
            params, qp = SP.model_state_abstract(model, cfg, policy)
            opt = SP.opt_state_abstract(qp)
            batch = SP.batch_specs_abstract(cfg, shape)
            q_spec = SH.qparam_specs(model, params, qp, rules)
            return (dev_bytes(params, SH.param_specs(model, params, rules))
                    + dev_bytes(qp, q_spec)
                    + dev_bytes(opt, jax.tree.map(lambda _: P(), opt))
                    + dev_bytes(batch, SH.batch_specs(batch, rules)))
        serve, qp = SP.serve_state_abstract(model, cfg, policy)
        total = (dev_bytes(serve, SH.param_specs(model, serve, rules))
                 + dev_bytes(qp, SH.qparam_specs(model, serve, qp, rules)))
        if shape.kind == "prefill":
            batch = SP.batch_specs_abstract(cfg, shape)
            batch.pop("labels", None)
            cache_len = shape.seq_len if cfg.family != "encdec" else max(
                shape.seq_len // cfg.dec_ratio, 4)
            total += dev_bytes(batch, SH.batch_specs(batch, rules))
        else:
            cache_len = shape.seq_len
            tok = SP.sds((shape.global_batch, 1), jnp.int32)
            total += dev_bytes(tok, SH.batch_specs(tok, rules))
        cache = SP.cache_abstract(model, cfg, shape.global_batch, cache_len)
        return total + dev_bytes(cache, SH.cache_specs(cache, rules, 16))

    def cells_bytes(arch, smoke, scan=False):
        cfg = get_config(arch, smoke=smoke).replace(scan_layers=scan)
        model = build_model(cfg)
        out = {}
        for s in SHAPES:
            if not cell_applicable(arch, s)[0]:
                continue
            try:
                out[s] = cell_bytes(model, cfg, SHAPES[s], rules_of["default"])
            except ValueError as e:
                out[s] = "error: " + str(e)
        return out

    if stacked:
        out = {}
        for arch in ARCHS:
            unrolled = cells_bytes(arch, False, scan=False)
            scanned = cells_bytes(arch, False, scan=True)
            out[arch] = {s: (scanned[s] - unrolled[s]
                             if isinstance(unrolled[s], int)
                             and isinstance(scanned[s], int) else
                             [scanned[s], unrolled[s]]) for s in unrolled}
        return out

    out = {"applicable": {f"{a}|{s}": list(cell_applicable(a, s))
                          for a in ARCHS for s in SHAPES},
           "archs": list(ARCHS),
           "all_cells": [list(c) for c in all_cells(ARCHS)],
           "counts": {a: [get_config(a).param_count(),
                          get_config(a).active_param_count()]
                      for a in ARCHS},
           "specs": {}, "bytes": {}}
    policy = A.QuantPolicy()
    cases = [(a, True) for a in ARCHS] + [(a, False) for a in FULL]
    for arch, smoke in cases:
        cfg = get_config(arch, smoke=smoke).replace(scan_layers=False)
        model = build_model(cfg)
        params, qp = SP.model_state_abstract(model, cfg, policy)
        serve, sqp = SP.serve_state_abstract(model, cfg, policy)
        batch = SP.batch_specs_abstract(cfg, SHAPES[BATCH_SHAPE])
        tok = SP.sds((CACHE_B, 1), jnp.int32)
        cache = SP.cache_abstract(model, cfg, CACHE_B, CACHE_S)
        name = f"{arch}|{'smoke' if smoke else 'full'}"
        out["specs"][name] = {
            r: {"params": flat_specs(SH.param_specs(model, params, rules)),
                "qparams": flat_specs(SH.qparam_specs(model, params, qp,
                                                      rules)),
                "serve_params": flat_specs(SH.param_specs(model, serve,
                                                          rules)),
                "serve_qparams": flat_specs(SH.qparam_specs(model, serve,
                                                            sqp, rules)),
                "batch": flat_specs(SH.batch_specs(batch, rules)),
                "tokens": flat_specs(SH.batch_specs(tok, rules)),
                "cache": flat_specs(SH.cache_specs(cache, rules, 16))}
            for r, rules in rules_of.items()}
        out["bytes"][name] = cells_bytes(arch, smoke)
    return out


if __name__ == "__main__":
    print(json.dumps(_reference_main("--stacked" in sys.argv)))
    sys.exit(0)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.analysis.cost import CostCounter  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec,  # noqa: E402
                                 all_cells, cell_applicable, get_config)
from repro_torch.core import api as A  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import MetaGenerator  # noqa: E402

PORT_RULES = {"default": SH.ShardingRules(),
              "multipod": SH.multipod(SH.ShardingRules()),
              "act_seq_none": SH.ShardingRules(act_seq=None),
              "kv_seq": SH.ShardingRules(kv_cache_layout="seq")}
MESH_16 = {"data": 16, "model": 16}


def _env(**kw) -> dict:
    # one thread: neither side computes on tensors, and the tests of the
    # port run beside them
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **kw)


@pytest.fixture(scope="module", autouse=True)
def _background(tmp_path_factory):
    """The two slow runs, started with the file's first test and read by
    the tests that need them (the others run meanwhile): the reference's
    side, and ``main(["--all"])`` at SMOKE on 1x1 (``REPRO_N_MICRO=1``)."""
    out = tmp_path_factory.mktemp("dryrun_all")
    code = ("from repro_torch.launch.dryrun import main; "
            f"main(['--all', '--out', {str(out)!r}], smoke=True, "
            "mesh_shape=(1, 1))")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--reference"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "all": subprocess.Popen(
            [sys.executable, "-c", code], env=_env(REPRO_N_MICRO="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    yield procs, out
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _finish(proc) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def reference(_background):
    return json.loads(_finish(_background[0]["reference"]
                              ).strip().splitlines()[-1])


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {_key(prefix): json.loads(json.dumps(list(tree)))}


_CASES = [(a, True) for a in ARCHS] + [(a, False) for a in FULL]


def _port_cell_bytes(arch, smoke, shape, mesh, gen=None):
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    cell = D.cell_inputs(model, A.QuantPolicy(), shape, SH.ShardingRules(),
                         mesh["model"], gen or MetaGenerator())
    return D._named_bytes(cell.named, mesh), cell


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


_SMALL = {"train": ShapeSpec("t", "train", 32, 4),
          "prefill": ShapeSpec("p", "prefill", 32, 2),
          "decode": ShapeSpec("d", "decode", 32, 2)}


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b",
                                  "mixtral-8x7b", "hymba-1.5b",
                                  "seamless-m4t-medium", "llava-next-34b"])
def test_argument_bytes_1x1_equal_real_trees(arch):
    """On 1x1 the predicted argument bytes are the real CPU-built trees'
    bytes, every leaf counted once."""
    one = {"data": 1, "model": 1}
    for shape in _SMALL.values():
        predicted, _ = _port_cell_bytes(arch, True, shape, one)
        _, cell = _port_cell_bytes(arch, True, shape, one,
                                   torch.Generator().manual_seed(0))
        real = 0
        for tree, _spec in cell.named.values():
            real += sum(t.numel() * t.element_size()
                        for t in _leaves(tree))
        assert predicted == real, shape.kind


def _counted(arch, shape, gen):
    from repro_torch.models import attention, layers

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    cell = D.cell_inputs(model, A.QuantPolicy(), shape, SH.ShardingRules(),
                         1, gen)
    # the module-level constants made before the counted run, on either
    # device (made inside it, they would count there and not after)
    dev = torch.device(gen.device)
    layers.rotary_freqs(cfg.head_dim, cfg.rope_base, dev)
    attention.sqrt_d(cfg.head_dim, dev)
    attention.softmax_scale(cfg.head_dim, dev)
    with CostCounter() as c:
        cell.step(*cell.args)
    return (c.dot_flops, c.kernel_flops, c.bytes, c.peak,
            {k: v[0] for k, v in c.by_kernel.items()})


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_counts_equal_cpu_counts(arch, kind):
    """The meta trace counts the FLOPs, unfused bytes, peak live bytes and
    kernel calls of the same step on real CPU tensors (whose plain
    versions run, uncounted, inside the wrappers' scope)."""
    shape = _SMALL[kind]
    meta = _counted(arch, shape, MetaGenerator())
    cpu = _counted(arch, shape, torch.Generator().manual_seed(0))
    assert meta == cpu
    assert meta[0] + meta[1] > 0 and meta[3] > 0


def test_smollm_prefill_flops_closed_form():
    """smollm-135m SMOKE prefill: the dot FLOPs are the tied readout of the
    last position, 2·B·d·Vp; the kernel FLOPs are B3 over the seven
    projections of every layer and B2's causal QK and PV products."""
    cfg = get_config("smollm-135m", smoke=True)
    shape = _SMALL["prefill"]
    b, s = shape.global_batch, shape.seq_len
    dot, kern, _, _, calls = _counted("smollm-135m", shape, MetaGenerator())
    d, hd, h, kv, f = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                       cfg.n_kv_heads, cfg.d_ff)
    assert dot == 2 * b * d * cfg.vocab_padded
    proj = 2 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d
                        + 3 * d * f)
    attn = 4 * b * h * hd * (s * (s + 1) // 2)
    assert kern == cfg.n_layers * (proj + attn)
    assert calls == {"quant_matmul": 7 * cfg.n_layers,
                     "prefill_attention": cfg.n_layers}


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        t = torch.randn(shape, generator=g)
        return t.to(dtype)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8)

    scales = lambda: (torch.rand(2, generator=g) + 0.5) / 127  # noqa: E731
    b, s, kv, grp, dd = 2, 16, 2, 2, 8
    from repro_torch.cache.base import KernelView
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pool = (i8(4, 8, kv, dd), i8(4, 8, kv, dd))
    return {
        "quant_matmul": (ops.quant_matmul, (r(5, 16), i8(16, 8),
                                            torch.rand(8) / 100,
                                            torch.tensor(20.0)), {}),
        "quant_matmul_acc": (ops.quant_matmul_acc,
                             (i8(5, 16), i8(16, 8), 4, 12), {}),
        "decode_attention": (ops.decode_attention,
                             (r(b, kv, grp, dd), i8(b, s, kv, dd),
                              i8(b, s, kv, dd), scales(), scales(), 9), {}),
        "decode_attention_partials": (
            ops.decode_attention_partials,
            (r(b, kv, grp, dd), i8(b, s, kv, dd), i8(b, s, kv, dd),
             scales(), scales(), 9), {}),
        "prefill_attention": (ops.prefill_attention,
                              (r(b, s, kv, grp, dd), i8(b, s, kv, dd),
                               i8(b, s, kv, dd), scales(), scales(), 0, s),
                              {"window": 4}),
        "decode_attention_view": (
            ops.decode_attention_view,
            (r(b, kv, grp, dd), KernelView(*pool, table), scales(),
             scales(), 11), {}),
        "decode_attention_partials_view": (
            ops.decode_attention_partials_view,
            (r(b, kv, grp, dd), KernelView(*pool, table), scales(),
             scales(), 11), {}),
        "prefill_attention_view": (
            ops.prefill_attention_view,
            (r(b, 4, kv, grp, dd), KernelView(*pool, table), scales(),
             scales(), 8, 12), {}),
        "fake_quant": (ops.fake_quant, (r(6, 8), torch.rand(8) + 1,
                                        torch.ones(8)), {}),
    }


def _to_meta(x):
    from repro_torch.cache.base import KernelView

    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, KernelView):
        return KernelView(*(_to_meta(t) for t in x))
    return x


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_meta_route_shapes_and_no_plain_version(name, monkeypatch):
    """On meta each wrapper returns its CPU plain version's shapes and
    dtypes, and runs no plain version."""
    fn, args, kw = _wrapper_cases()[name]
    want = fn(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta")

    for attr in dir(ref):
        if attr.endswith("_ref"):
            monkeypatch.setattr(ref, attr, refuse)
    ops.reset_launches()
    got = fn(*(_to_meta(a) for a in args), **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert ops.plain_call_count() == 0
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]


def test_main_all_smoke_writes_every_cell(_background, capsys):
    """``--all`` at SMOKE on 1x1 writes one report per applicable cell and
    prints the reference's six SKIP lines (``REPRO_N_MICRO`` overrides
    the microbatch count); a second run skips a cached cell."""
    procs, out = _background
    printed = _finish(procs["all"])
    skips = [ln for ln in printed.splitlines() if ln.startswith("SKIP ")]
    assert len(skips) == 6
    assert all(ln.endswith("x long_500k: " + cell_applicable(
        ln.split()[1], "long_500k")[1]) for ln in skips)
    files = sorted(p.name for p in out.iterdir())
    assert files == sorted(f"{a}_{s}_1x1.json" for a, s in all_cells(ARCHS))
    rep = json.loads((out / "mixtral-8x7b_train_4k_1x1.json").read_text())
    assert rep["n_micro"] == 1 and rep["chips"] == 1
    m = rep["memory_analysis"]
    assert m["peak_bytes_per_device"] == m["argument_bytes"] + \
        m["temp_bytes"]
    assert rep["collective_bytes_per_device"] is None
    assert rep["roofline"]["collective_s"] is None
    assert rep["roofline"]["dominant"] in ("compute_s", "memory_s")
    D.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out",
            str(out)], smoke=True, mesh_shape=(1, 1))
    assert "[cached] smollm-135m_decode_32k_1x1" in capsys.readouterr().out


def test_undivided_batch_fails_the_cell(tmp_path):
    """On 16x16 a long_500k cell's batch of 1 does not split over 16 data
    devices: the cell fails with the reference's lowering error, and the
    CLI lists it and exits 1."""
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--out",
                str(tmp_path)], smoke=True)
    assert e.value.code == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_applicable_and_counts(reference, arch):
    """The same cells, the same reasons, the same parameter counts."""
    for s in SHAPES:
        assert list(cell_applicable(arch, s)) == \
            reference["applicable"][f"{arch}|{s}"], s
    assert sorted(ARCHS) == sorted(reference["archs"])
    assert [list(c) for c in all_cells(reference["archs"])] == \
        reference["all_cells"]
    cfg = get_config(arch)
    assert [cfg.param_count(), cfg.active_param_count()] == \
        reference["counts"][arch]


@pytest.mark.parametrize("arch,smoke", _CASES,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in _CASES])
def test_spec_trees_match_reference(reference, arch, smoke):
    """Every leaf of the param, qparam (training and serving), batch, token
    and cache trees carries the reference's spec, under each of the four
    rule sets."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    policy = A.QuantPolicy()
    params, qp = SP.model_state_abstract(model, cfg, policy)
    serve, sqp = SP.serve_state_abstract(model, cfg, policy)
    batch = SP.batch_specs_abstract(cfg, SHAPES[BATCH_SHAPE])
    tok = torch.empty((CACHE_B, 1), dtype=torch.int32, device="meta")
    cache = SP.cache_abstract(model, cfg, CACHE_B, CACHE_S)
    want = reference["specs"][f"{arch}|{'smoke' if smoke else 'full'}"]
    for r, rules in PORT_RULES.items():
        got = {"params": SH.param_specs(model, params, rules),
               "qparams": SH.qparam_specs(model, params, qp, rules),
               "serve_params": SH.param_specs(model, serve, rules),
               "serve_qparams": SH.qparam_specs(model, serve, sqp, rules),
               "batch": SH.batch_specs(batch, rules),
               "tokens": SH.batch_specs(tok, rules),
               "cache": SH.cache_specs(cache, rules, 16)}
        for tree, specs in got.items():
            assert _flat(specs) == want[r][tree], (r, tree)


@pytest.mark.parametrize("arch,smoke", _CASES,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in _CASES])
def test_argument_bytes_16x16_match_reference(reference, arch, smoke):
    """Per-device argument bytes of every applicable cell on 16x16 equal
    those of the reference's shard shapes; a cell whose batch does not
    divide fails on both sides."""
    want = reference["bytes"][f"{arch}|{'smoke' if smoke else 'full'}"]
    assert sorted(want) == sorted(s for s in SHAPES
                                  if cell_applicable(arch, s)[0])
    for s, w in want.items():
        if isinstance(w, str):
            assert "partitioned 16 times, but the dimension size is 1" in w
            with pytest.raises(ValueError, match="divisible by 16, but it "
                               "is equal to 1"):
                _port_cell_bytes(arch, smoke, SHAPES[s], MESH_16)
        else:
            assert _port_cell_bytes(arch, smoke, SHAPES[s], MESH_16)[0] \
                == w, s
