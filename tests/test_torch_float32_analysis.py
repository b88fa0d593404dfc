"""The float32 configs' serving steps under the analysis contracts, and
their card routes.

smollm-135m built with dtype float32 serves over a float32 cache (modes
``int8_w_bf16_kv`` and ``bf16_w_bf16_kv``: B2's float32 branch a layer and
prefill); granite-moe-3b-a800m built with dtype float32 serves its expert
products through B3's float32 output (3 x E launches a layer and pass).
At ``SMOKE`` on the CPU: ``Engine.analyze()`` finds nothing, the launch
formulas (``kernel_contracts.expected_launches``) count the float32
variants, and with the route forced to the card's the wrappers reach their
CUDA launch with float32 operands and raise nothing on the way.
"""

import pytest
import torch

from repro_torch.analysis import entrypoints as EP
from repro_torch.analysis import kernel_contracts as KC
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.launch import steps as ST
from repro_torch.launch.engine import Engine

ENGINES = {"smollm int8_w_bf16_kv": ("smollm-135m", dict(kv_int8=False)),
           "smollm bf16_w_bf16_kv": ("smollm-135m",
                                     dict(fp=True, kv_int8=False)),
           "granite-moe int8": ("granite-moe-3b-a800m", {})}


@pytest.fixture(scope="module", params=list(ENGINES))
def engine(request):
    arch, flags = ENGINES[request.param]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    return Engine.from_checkpoint(cfg=cfg, device="cpu", **flags)


def test_analyze_finds_nothing(engine):
    assert engine.analyze() == []


def test_launch_formulas_count_the_float32_variants(engine):
    """The formulas of a float32 engine's prefill: B2's float32 counter
    over a float cache (never the bf16 one), B3's float32 counter once per
    expert product; the recorded calls advance exactly those."""
    cfg = engine.cfg
    want = EP.engine_expected(engine, "prefill", 1)
    assert want is not None
    float_cache = not engine.policy.kv_int8
    assert want.get(("prefill_attention", "launches_f32"), 0) == (
        cfg.n_layers if float_cache else 0)
    assert ("prefill_attention", "launches_bf16") not in want
    experts = cfg.n_experts if cfg.ffn == "moe" else 0
    assert want.get(("quant_matmul", "launches_f32"), 0) == \
        3 * experts * cfg.n_layers
    toks = EP.prompts(engine)
    cache = engine.init_cache(EP.B, EP.CACHE)
    ep = EP.record_step("prefill", lambda: ST.make_prefill_step(
        engine.model, engine.policy, mode=engine.mode)(
        engine.serve_params, engine.qparams, {"tokens": toks}, cache),
        "cpu", want)
    assert KC.recorded_launches(ep.record) == want


def test_expected_launches_float32_keys():
    """The formula by hand: a float32 config over a float cache counts
    B2's float32 variant, a bf16 one its bf16 variant; experts add 3 x E
    B3 launches a layer and pass, float32-output ones only at float32."""
    f32 = KC.expected_launches(30, "prefill", 1, kv_float=True, f32=True)
    assert f32[("prefill_attention", "launches_f32")] == 30
    assert ("prefill_attention", "launches_bf16") not in f32
    bf16 = KC.expected_launches(30, "prefill", 1, kv_float=True)
    assert bf16[("prefill_attention", "launches_bf16")] == 30
    moe = KC.expected_launches(4, "decode", 3, f32=True, projections=4,
                               experts=40)
    assert moe[("quant_matmul", "launches")] == (4 + 120) * 4 * 3
    assert moe[("quant_matmul", "launches_f32")] == 120 * 4 * 3
    assert moe[("decode_attention", "launches")] == 12


def _card_route(monkeypatch):
    """Every wrapper takes its CUDA route on these CPU tensors; the
    launches are recorded (their operands validated by the wrapper's own
    ``check``) and answered by the plain versions."""
    seen = []

    def qm_launch(x, w_q, w_scale, act_scale, w_bits=8, out=None,
                  out_dtype=torch.bfloat16):
        tqm.check(x, w_q, w_scale, act_scale, w_bits, out, out_dtype)
        seen.append(("quant_matmul", out_dtype))
        y = ops.ref.quant_matmul_ref(x, w_q, w_scale, act_scale, w_bits,
                                     out_dtype)
        return y if out is None else out.copy_(y)

    def pa_launch(q, k, v, k_scale, v_scale, q_start, kv_len, *,
                  causal=True, window=None, kv_bits=8, table=None):
        tpa.check(q, k, v, k_scale, v_scale, q_start, kv_len, window,
                  kv_bits, table)
        seen.append(("prefill_attention", k.dtype))
        kw = dict(causal=causal, window=window, kv_bits=kv_bits)
        if table is None:
            return ops.ref.prefill_attention_ref(
                q, k, v, k_scale, v_scale, q_start, kv_len, **kw)
        return ops.ref.prefill_attention_paged_ref(
            q, k, v, table, k_scale, v_scale, q_start, kv_len, **kw)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tqm, "launch", qm_launch)
    monkeypatch.setattr(tpa, "launch", pa_launch)
    return seen


def test_card_routes_take_float32(engine, monkeypatch):
    """With the route forced to the card's, a float32 engine's prefill
    reaches B2's launch with float32 K/V over a float cache and B3's with
    a float32 output for every expert product: no ``NotImplementedError``
    (the experts' old bf16-only route) and no ``TypeError`` on the way."""
    seen = _card_route(monkeypatch)
    toks = EP.prompts(engine)
    cache = engine.init_cache(EP.B, EP.CACHE)
    with torch.inference_mode():
        ST.make_prefill_step(engine.model, engine.policy, mode=engine.mode)(
            engine.serve_params, engine.qparams, {"tokens": toks}, cache)
    cfg = engine.cfg
    b2 = [d for k, d in seen if k == "prefill_attention"]
    assert len(b2) == cfg.n_layers
    assert set(b2) == {torch.float32 if not engine.policy.kv_int8
                       else torch.int8}
    b3_f32 = sum(1 for k, d in seen if k == "quant_matmul"
                 and d == torch.float32)
    assert b3_f32 == 3 * cfg.n_layers * (cfg.n_experts if cfg.ffn == "moe"
                                         else 0)


@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_b2_launch_refuses_float32_only_past_d128(d):
    """B2's launch takes its storage code from ``storage_code``: a float32
    K/V stream is code 32 at every D <= 128 and refused past 128 with a
    TypeError naming ROADMAP Queue B (the wide library has no float32
    branch); bf16 is 16, int8 and packed int4 their widths."""
    kv = torch.zeros((1, 8, 2, d))
    if d <= 128:
        assert tpa.storage_code(kv, 8, d) == 32
    else:
        with pytest.raises(TypeError, match="Queue B"):
            tpa.storage_code(kv, 8, d)
    assert tpa.storage_code(kv.bfloat16(), 8, d) == 16
    assert tpa.storage_code(kv.to(torch.int8), 8, d) == 8
    assert tpa.storage_code(kv.to(torch.int8), 4, d) == 4
