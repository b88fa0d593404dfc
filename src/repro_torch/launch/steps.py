"""Step functions: §2 calibration, the FAT threshold fine-tune (§3), the
pretrain step, one-shot and chunked ragged prefill, the single-stream
decode loop and the continuous-batching decode block (greedy or sampled).

Counterparts of ``repro/launch/steps.py`` (``make_calibrate_step``,
``make_fat_train_step``, ``finetune_thresholds``, ``make_pretrain_step``,
``make_prefill_step``,
``pad_for_chunked_prefill``, ``make_decode_loop``,
``make_slot_decode_loop``).  The
reference's ``lax.scan`` loops are Python loops here.  The serving steps
(the prefills, the decode steps, the slot block) are capturable: they
read nothing back to the host, make no tensor from host data, and their
loops have trip counts and offsets fixed by the shapes, so
``launch/graphs.py`` captures each whole (the chunked prefill is one
graph, as the reference's scan over chunks is one program).  ``argmax``
takes the first maximum, like ``jnp.argmax``.  The decode strategies
(greedy, sampled, speculative) are ``launch/strategies.py``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import api as A
from repro_torch.core.distill import chunked_ce_loss, chunked_sq_err
from repro_torch.models.transformer import attention_only
from repro_torch.optim.adam import adam_init, adam_update, cosine_restarts


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    base_lr: float = 1e-3
    anneal_period: int = 100   # cosine restart period (steps)
    weight_decay: float = 0.0
    aux_weight: float = 0.01   # MoE load-balance weight (pretrain mode)


def make_calibrate_step(model, policy: A.QuantPolicy):
    def calibrate_step(params, qparams, batch):
        ctx = A.make_ctx("calibrate", policy, qparams)
        model.hidden(params, batch, ctx)
        merged = dict(qparams)
        for path, obs in ctx.updates.items():
            if A.is_kv_path(path):
                merged[path] = obs
            else:
                merged[path] = {**merged[path], "act": obs}
        return merged

    return calibrate_step


def make_fat_grad_fn(model, policy: A.QuantPolicy, n_micro: int = 1):
    """The FAT distillation objective and its gradient: ``(params,
    qparams, batch) -> (loss, grads)``.

    The teacher is the full-precision forward (no context), the student
    the fake-quantized forward with the thresholds in ``qparams``; the loss
    is eq. 25's RMSE over the logits (``chunked_sq_err``).  Weights are
    frozen (they never take a gradient); ``grads`` holds the gradient of
    every trainable qparams leaf (``A.trainable_mask``), keyed by its
    ``A.flatten`` path.  ``n_micro`` > 1 splits the batch into that many
    microbatches and averages their losses and gradients."""
    cfg = model.cfg

    def loss_for(qp, params, batch):
        with torch.no_grad():
            h_t = model.hidden(params, batch, None)
        ctx = A.make_ctx("fake", policy, qp)
        h_s = model.hidden(params, batch, ctx)
        sq, n = chunked_sq_err(h_t, h_s, model.readout_fn(params, None),
                               model.readout_fn(params, ctx),
                               chunk=cfg.loss_chunk)
        return torch.sqrt(sq / n)                       # eq. 25

    def loss_and_grads(params, qparams, batch):
        mask = A.flatten(A.trainable_mask(qparams))
        # fresh leaves, so thresholds made under inference mode or shared
        # with the caller never enter the graph themselves
        leaves = {k: v.detach().clone().requires_grad_(mask[k])
                  for k, v in A.flatten(qparams).items()}
        keys = [k for k in leaves if mask[k]]
        qp = A.unflatten(leaves)
        if any(t.shape[0] % n_micro for t in batch.values()):
            raise ValueError(f"batch does not split into {n_micro} "
                             "microbatches")
        micro = [dict(zip(batch, parts)) for parts in zip(
            *(t.chunk(n_micro, dim=0) for t in batch.values()))]
        loss, grads = None, {}
        for mb in micro:
            lm = loss_for(qp, params, mb)
            gs = torch.autograd.grad(lm, [leaves[k] for k in keys],
                                     allow_unused=True)
            loss = lm.detach() if loss is None else loss + lm.detach()
            for k, g in zip(keys, gs):
                # a trainable leaf the forward does not read (the
                # asymmetric scheme's alpha_t / alpha_r) has gradient 0
                g = torch.zeros_like(leaves[k]) if g is None else g
                grads[k] = g if k not in grads else grads[k] + g
        if n_micro > 1:
            loss = loss / n_micro
            grads = {k: g / n_micro for k, g in grads.items()}
        return loss, grads

    return loss_and_grads


def make_fat_train_step(model, policy: A.QuantPolicy,
                        hp: TrainHParams = TrainHParams(), n_micro: int = 1):
    """The FAT QAT step: ``(params, qparams, opt_state, batch) ->
    (qparams, opt_state, {"loss", "lr"})``.  Adam, masked to the trainable
    leaves, at the cosine-annealed rate of the step count before this step
    (§3.1.3: "All network parameters except quantization thresholds are
    fixed"; §4.1.2)."""
    grad_fn = make_fat_grad_fn(model, policy, n_micro)

    def train_step(params, qparams, opt_state, batch):
        loss, grads = grad_fn(params, qparams, batch)
        lr = cosine_restarts(opt_state.step, hp.base_lr, hp.anneal_period)
        mask = A.flatten(A.trainable_mask(qparams))
        new_qp, new_opt = adam_update(grads, opt_state, A.flatten(qparams),
                                      lr, mask=mask)
        return A.unflatten(new_qp), new_opt, {"loss": loss, "lr": lr}

    return train_step


def finetune_thresholds(model, policy: A.QuantPolicy, params, qparams,
                        batches, *, epochs: int = 4,
                        hp: TrainHParams = TrainHParams(),
                        step_seconds: list | None = None):
    """Train the quantization thresholds by distillation (paper §3 + TQT):
    ``epochs`` passes of the FAT step over ``batches`` (the calibration
    set).  With ``finalize_calibration(..., train_thresholds=True)``
    qparams the trainable set includes the per-head KV ``log2_t``.
    ``epochs`` is capped at 8, as in the reference.  Returns ``(qparams,
    losses)``, one loss per step; each step's wall time (it ends when its
    loss reaches the host) is appended to ``step_seconds`` if given."""
    if not 1 <= epochs <= 8:
        raise ValueError(f"epochs must be in [1, 8], got {epochs}")
    batches = list(batches)
    if not batches:
        raise ValueError("finetune_thresholds needs >= 1 calibration batch")
    train_step = make_fat_train_step(model, policy, hp)
    opt = adam_init(A.flatten(qparams))
    losses = []
    for _ in range(epochs):
        for batch in batches:
            t0 = time.perf_counter()
            qparams, opt, metrics = train_step(params, qparams, opt, batch)
            losses.append(float(metrics["loss"]))
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
    return qparams, losses


def make_pretrain_step(model, hp: TrainHParams = TrainHParams()):
    """Plain LM training (the substrate mode): ``(params, opt_state, batch)
    -> (params, opt_state, {"loss", "lr"})``.  Next-token CE through the
    full-precision readout plus ``hp.aux_weight`` times the MoE
    load-balance loss (zero without MoE layers), the gradient w.r.t. every
    weight, and Adam with ``hp.weight_decay`` at the cosine-annealed rate;
    ``opt_state`` is keyed like ``A.flatten(params)``.  A VLM's loss reads
    its text positions only (the patches come first)."""
    cfg = model.cfg

    def pretrain_step(params, opt_state, batch):
        flat = A.flatten(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        p = A.unflatten(leaves)
        h, aux = model.hidden(p, batch, None, with_aux=True)
        if cfg.modality == "vlm":
            h = h[:, cfg.mm_patches:, :]
        loss = chunked_ce_loss(h, batch["labels"], model.readout_fn(p),
                               chunk=cfg.loss_chunk) + hp.aux_weight * aux
        grads = torch.autograd.grad(loss, list(leaves.values()))
        lr = cosine_restarts(opt_state.step, hp.base_lr, hp.anneal_period)
        new_flat, new_opt = adam_update(dict(zip(leaves, grads)), opt_state,
                                        flat, lr,
                                        weight_decay=hp.weight_decay)
        return A.unflatten(new_flat), new_opt, {"loss": loss.detach(),
                                                "lr": lr}

    return pretrain_step


def pad_for_chunked_prefill(tokens: torch.Tensor, chunk: int, lengths=None):
    """Pad (B, S) tokens with zeros up to a ``chunk`` multiple; returns
    (tokens, (B,) int32 lengths), the lengths defaulting to S."""
    b, s = tokens.shape
    s_pad = -(-s // chunk) * chunk
    if s_pad != s:
        tokens = torch.nn.functional.pad(tokens, (0, s_pad - s))
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32)
    return tokens, torch.as_tensor(lengths, dtype=torch.int32,
                                   device=tokens.device)


def attn_cache_len(cache) -> int:
    """Logical capacity of the first attention cache of a stack's cache
    tree (paged: blocks x page size); raises on a tree without one (an
    attention-free stack, mamba2)."""
    for layer in cache.values():
        if "attn" in layer:
            return layer["attn"].capacity
    raise ValueError("the cache tree holds no attention cache (an "
                     "attention-free stack has no KV capacity)")


def make_prefill_step(model, policy: A.QuantPolicy,
                      prefill_chunk: int | None = None, mode: str = "int8"):
    """Serving prefill (``mode`` "int8": int8 weights; "none": the
    full-precision weights) into the KV cache.

    One-shot (``prefill_chunk`` None): ``(params, qparams, batch, cache) ->
    (logits of the last position (B, 1, Vp), cache)``, the whole batch to
    the model (an encoder-decoder's ``frames``, a VLM's ``patches``).  Chunked: ``(params,
    qparams, batch, cache, lengths) -> (logits, cache)`` over tokens padded
    to a chunk multiple (``pad_for_chunked_prefill``), with a per-request
    length vector: each chunk appends its K/V at absolute slots and attends
    the growing cache, and the loop keeps each request's last VALID hidden
    state, so the readout runs once, on (B, 1, d)."""
    if prefill_chunk is None:
        def prefill_step(serve_params, qparams, batch, cache):
            ctx = A.make_ctx(mode, policy, qparams)
            return model.prefill(serve_params, batch, cache, ctx)

        return prefill_step

    cfg = model.cfg
    if not attention_only(cfg):
        kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
        raise ValueError(
            "chunked prefill covers attention-only text stacks: SSM state "
            "folding has no per-request length masking yet "
            f"(got kinds={sorted(kinds)}, modality={cfg.modality})")

    def chunked_prefill_step(serve_params, qparams, batch, cache, lengths):
        ctx = A.make_ctx(mode, policy, qparams)
        tokens = batch["tokens"]
        b, s_max = tokens.shape
        if s_max % prefill_chunk:
            raise ValueError(
                f"tokens length {s_max} must pad to a multiple of "
                f"prefill_chunk={prefill_chunk} "
                "(steps.pad_for_chunked_prefill)")
        cache_len = attn_cache_len(cache)
        if s_max > cache_len:
            raise ValueError(
                f"padded prompt {s_max} exceeds the cache length "
                f"{cache_len}; size the cache to at least the padded "
                "prompt (prompt_len rounded up to prefill_chunk) + gen")
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=tokens.device)
        last = lengths.to(torch.long) - 1
        h_last = torch.zeros((b, 1, cfg.d_model), dtype=cfg.dtype,
                             device=tokens.device)
        for c0 in range(0, s_max, prefill_chunk):
            h, cache = model.prefill_chunk(
                serve_params, tokens[:, c0:c0 + prefill_chunk], cache, c0,
                ctx, lengths=lengths, kv_limit=s_max)
            # requests whose last valid token lies in this chunk take its
            # hidden state; the others keep theirs
            here = (last >= c0) & (last < c0 + prefill_chunk)
            idx = torch.clamp(last - c0, 0, prefill_chunk - 1)
            h_sel = torch.gather(h, 1, idx.reshape(b, 1, 1).expand(
                b, 1, h.shape[-1]))
            h_last = torch.where(here.reshape(b, 1, 1), h_sel.to(h_last.dtype),
                                 h_last)
        return model.readout_fn(serve_params, ctx)(h_last), cache

    return chunked_prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids, first maximum on ties."""
    return torch.argmax(logits, dim=-1)


def make_decode_loop(model, policy: A.QuantPolicy, n_steps: int = 16,
                     mode: str = "int8", temperature: float = 0.0,
                     top_p: float = 1.0):
    """Whole-generation decode in serving ``mode`` ("int8" or "none"),
    greedy or (``temperature`` > 0) sampled: ``(params, qparams, tok0 (B,),
    cache, pos0, key=None) -> (tokens (B, n_steps), cache)`` with
    tokens[:, 0] == tok0 and n_steps - 1 decode steps, each at the host int
    position ``pos0 + i`` (the eager ``loop=True`` driver), a sampled step
    splitting the (2,) key once.  A wrapper over
    ``strategies.make_strategy_decode_loop``, as in the reference."""
    from repro_torch.launch import strategies as SG

    strategy = SG.make_strategy(None, model, policy, temperature=temperature,
                                top_p=top_p, mode=mode)
    return SG.make_strategy_decode_loop(model, policy, strategy,
                                        n_steps=n_steps)


def make_slot_decode_loop(model, policy: A.QuantPolicy, n_steps: int = 8,
                          eos_id: int = -1, mode: str = "int8",
                          temperature: float = 0.0, top_p: float = 1.0):
    """One continuous-batching decode block of ``n_steps`` one-token steps
    (greedy, or sampled at ``temperature`` > 0) over a slot batch where
    every slot sits at its own position: ``(params, qparams, tok0 (B,),
    cache, pos0 (B,), active0 (B,), key=None) -> (toks (B, n_steps),
    emitted (B, n_steps) bool, cache, pos, active, key)``.
    ``emitted[b, i]`` marks real tokens (an EOS itself is emitted, nothing
    after it); ``eos_id < 0`` disables EOS detection.  ``key`` is one (2,)
    key or (B, 2) per-slot keys.  A wrapper over
    ``strategies.make_strategy_slot_loop``, as in the reference."""
    from repro_torch.launch import strategies as SG

    inner = SG.make_strategy_slot_loop(
        model, policy, SG.make_strategy(None, model, policy,
                                        temperature=temperature, top_p=top_p,
                                        mode=mode),
        n_steps=n_steps, eos_id=eos_id)

    def slot_decode_loop(serve_params, qparams, tok0, cache, pos0, active0,
                         key=None):
        toks, emitted, cache, pos, active, key, _, _ = inner(
            serve_params, qparams, tok0, cache, pos0, active0, key)
        return toks, emitted, cache, pos, active, key

    return slot_decode_loop
