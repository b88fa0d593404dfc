#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. builds the hand-written Hopper kernels (``src/repro_torch/csrc``), one
   ``nvcc`` a library, all started together (the attention libraries go
   on compiling beside step 2's checks of B3 and B5, the D > 128
   ``_wide`` ones beside those at D <= 128, which run first; each is
   waited for before its first check), and checks that every instantiation of the prefill attention kernel runs on
   the tensor cores (HMMA in its SASS), every instantiation of
   quant_matmul's prefill kernel on the int8 tensor cores (IMMA) and every
   instantiation of its decode kernel on dp4a (IDP), none of them nor of
   the decode attention kernel (B1, B4) spilling registers; prints each
   library's nvcc time and the decode kernel's column tile and cluster
   size at each of smollm-135m's widths;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path (quant_matmul bit for bit at decode rows M = 4,
   8 and 1, each also timed with the L2 cache flushed, admission,
   paged-chunk and prefill rows, at the edge cases of ``QMM_EDGES``:
   rows 9-129, ragged K and N, .5 ties, the clip, |acc| > 2^24, and at
   ``QMM_DECODE_EDGES``: M = 1-8 at K and N that end a cluster slice, a
   column tile or a 16-byte piece early; the
   attentions with an int8 and a packed int4 K/V stream; the prefill
   attention also at the
   edge cases of ``PREFILL_EDGES``; the decode attention also at the chunk
   boundaries of its sequence split, and bit for bit against the same rows
   in a cache of 1024 positions; the prefill attention also over a bf16 K/V
   stream with unit scales, a float cache's, with bf16 and float32 q and
   at ``PREFILL_EDGES``), and times kernel (warm, and the attentions and
   fake_quant also with the L2 cache flushed), plain version and one
   PyTorch library call as a yardstick;
2b. the paper's side: [paper tables] runs ``python -m
   repro_torch.bench.run`` at the reference's sizes (Tables 1-2, the
   §3.3/§4.2 DWS sequence, the §3.2 convergence, with their ordering
   asserts; ``kernels_micro``: B3 and B5 bit for bit against their plain
   versions, then timed) and prints its CSV rows; [variants full] runs
   smollm-135m at full width through ``prepare_int8`` for each policy of
   ``VARIANT_POLICIES`` at ``SMOLLM_LAYERS`` of its 30 layers (scalar /
   vector weights x symmetric / asymmetric activations, the percentile
   observer, pointwise scales after ``prepare_int8``'s fine-tune, 3 FAT
   steps, beside the same steps at a tenth of the rate): the fake-mode
   rmse and top-1 agreement with the bf16 teacher,
   then the int8 form served through B3 and held against the same engine
   with the plain versions on the card (up to a near-tie);
3. drives the int8 main path at the full width of smollm-135m (30 layers,
   seeded random weights): ``Engine.from_checkpoint`` -> §2 calibration ->
   int8 conversion -> ``generate_batch`` on 4 prompts of 512 tokens with 32
   generated tokens, and checks that every kernel was launched by it.
   ``generate_batch`` replays its CUDA graphs (the prefill and one greedy
   decode step, captured by the warm-up call, ``compile_s``); every
   single-engine path also runs the eager ``loop=True`` driver with the
   same launch counts and must give its tokens and prefill logits bit for
   bit (``compare_programs``); the bf16 modes (4b), [graphs paged 16],
   the sampled and speculative paths, int4, the paged paths, the
   schedulers, resilience, recovery and sp (5-13) serve
   ``SMOLLM_LAYERS`` of the 30 layers, for the script's time.  [graphs
   profiler] checks that torch.profiler sees a replay's kernels; [graphs
   paged 16] serves pages
   of 16; [graphs cublas probe] holds the bf16 paths' cuBLAS products
   captured against eager; the [graphs] table before [time] gives every
   path's graph and eager walls, ``compile_s`` and device busy;
4. holds the GPU logits and greedy tokens against the same engine moved to
   the CPU (the plain versions), teacher-forced on the GPU's tokens;
4b. [bf16_w_bf16_kv], [bf16_w_int8_kv], [int8_w_bf16_kv]: the reference's
   other serving modes (``fp`` and ``kv_int8``) at full width, each through
   3 and 4: bf16 weights launch no quant_matmul, a bf16 KV cache runs its
   prefill through B2's bf16 branch and decodes in plain attention (no
   B1); with a breakdown of device time each; [int8_w_bf16_kv paged path]
   its paged twin (bf16 pool), bit-identical to the dense cache;
   [bf16_w_bf16_kv scheduler] 8 ragged requests through 8 slots of a bf16
   pool;
5. [finetune] builds the int4 engine with 2 epochs of the paper's §3
   threshold fine-tune on the card (``kv_bits=4, finetune_thresholds=2``)
   and checks its losses; fine-tunes from KV thresholds 4x too wide, where
   each batch's loss must fall; holds the first step's loss and threshold
   gradients against the same step on the CPU;
6. [int4 path] drives that engine's ``generate_batch`` (int4 KV cache,
   the kernels' int4 variants) and holds it against the CPU as in 4;
7. [kernels], paged: both attention kernels over a page pool read through
   a permuted block table (one page mapped into two rows), int8 and int4
   (and the prefill kernel over a bf16 pool), pages of 16 and 64, at the scheduler's decode shape and the paged
   path's prefill chunk (also at D 128, bf16 and float32 q): against their
   plain versions, and bit for bit against the dense kernel on the
   gathered copy; timed beside it;
8. [paged path] serves 4 x 512 prompts for 32 tokens through a paged cache
   with chunked prefill (chunks of 128, pages of 64): logits and tokens
   bit-identical to the same engine with a dense cache, every attention
   launch through the paged variants, no gather of the pool; [int4 paged
   path] the same for the int4 engine;
9. [scheduler] streams 16 ragged requests (prompts of 64-512 tokens, 32
   generated tokens each) through ``Engine.generate`` with 8 slots of the
   paged cache, and re-serves 4 of them alone through ``generate_batch``;
10. [prefix] serves 4 requests with one 512-token prompt: one prefill,
   three prefix-store hits, equal tokens;
11. [kernels], partials: the decode kernel's partials epilogue (B4, the
   sequence-parallel decode) on the 4 shard views of a 640-position cache
   (int8 and int4, read in place) and on a paged pool: against its plain
   version; one shard over the whole cache normalizes to the decode
   kernel's output bit for bit, and the merge of the 4 shards' partials
   equals the decode kernel over the whole cache;
12. [sp path] serves 4 x 512 prompts for 32 tokens through
   ``ShardedEngine.from_checkpoint(..., sp=4)`` (the cache's sequence axis
   in 4 shards, decode through B4 once per shard and layer, never B1) and
   holds it against the same engine moved to the CPU; [int4 sp path] the
   int4 engine's weights with sp=4;
13. [sp scheduler] streams 8 ragged requests through 4 slots of the sp=4
   engine and holds the completions against the unsharded scheduler on
   the same weights (equal up to a near-tie);
14. [kernels], fake_quant: B5 against its plain version bit for bit at the
   fat_qat student's widths (1024 x 1536, 1024 x 576), benchmarks/run.py's
   512 x 256 and a ragged 1000 x 1000, float32 and bf16, per-channel and
   scalar t_max, alphas below, inside and above [0.5, 1], .5 ties; then
   ``ops.fake_quant``'s forward and STE backward on the card against the
   CPU (dx bit for bit, dalpha rtol 1e-5); timed beside the plain version
   and torch.fake_quantize_per_channel_affine;
15. [kernels], quant_matmul int4 weights: B3 at ``w_bits=4`` bit for bit
   against its plain version and the int8 branch on the unpacked weights
   at smollm-135m's widths, M = 4, 8, 1, 128, 512, 2048 and 37; timed
   beside the int8 branch and torch._int_mm (the decode rows also with the
   L2 cache flushed);
16. [train fat_qat] ``repro_torch.launch.train.main`` at the full width of
   smollm-135m: 3 steps that checkpoint, the same command to 6 steps
   (resumes from step 3), and an uninterrupted 6-step run: the resumed
   thresholds equal the uninterrupted ones (rtol 1e-5);
17. [train pretrain] 4 pretrain steps at full width, the loss finite and
   falling, one checkpoint; [checkpoint serve] the int8 engine built from
   that checkpoint (``Engine.from_checkpoint(checkpoint_dir=)``) serves 4
   x 512 prompts for 32 tokens through B1-B3 with the checkpoint's
   weights, held against its CPU twin as in 4.
18. the decoding strategies (``launch/strategies.py``): [kernels] B2 at the
   speculative verify window (4 rows of ``SPEC_K`` + 1 queries, each at its
   own q_start, over a 640-position cache, one row with kv_len 0; int8 and
   int4, timed beside SDPA with an explicit mask) and at ``VERIFY_EDGES``
   and a paged window over 8 slots, B3 at M = 20 and 40; [sample path]
   the int8 main path sampled (``SAMPLING``, the reference's threefry key
   schedule on the card): graphs == eager bit for bit, the same seed the
   same tokens, another seed other tokens, the GPU tokens against the CPU
   engine teacher-forced with the same keys (equal, or the CPU's perturbed
   scores within ``LOGIT_ATOL``); [speculative path], [speculative paged
   16] and their int4 twins: every verify window's attention through B2,
   graphs == the same steps run eagerly bit for bit, tokens equal the
   same engine's greedy tokens up to a near-tie, windows, tokens per window and
   acceptance printed; [speculative scheduler] and [sampled scheduler]: 16
   ragged requests through 8 slots of the paged cache, completions against
   batch-1 runs up to a near-tie, sampled streams independent of arrival
   order, ``spec_stats()`` printed;
19. the dense decoders beyond smollm-135m: [kernels] holds B1, B2 and B4
   at the heads (KV, G, D) = (8, 4, 128), (8, 4, 160), (8, 2, 256) of
   granite-8b, stablelm-12b and gemma3-12b (int8, int4, bf16 K/V, dense
   and paged, the same rules as at D 64), B2 at gemma3's window of 1024
   over 2 x 2048 keys and B3 bit for bit at the three configs' widths
   (M = 1, 4, 8, 128, 2048; decode column tiles and clusters printed);
   [<arch> path] serves each config at full width, at the depth of
   ``PATH_LAYERS`` (10 of 40; gemma3 12 of 48, two local:global periods;
   weights drawn on the card) through ``drive_main_path`` with a
   breakdown, peak device memory and the resident int8 weight bytes;
   [gemma3-12b ring] serves 2 x 2048 prompts through its 10 rings of 1024
   slots and holds the tokens against dense caches; [<arch> cpu check]
   holds a full-width copy of depth 2 against the CPU;
20. the mixture-of-experts decoders: [kernels] holds B3 at every expert
   product of granite-moe-3b-a800m and mixtral-8x7b, one expert's three
   calls at the rows their paths give it (4 groups x capacity 8 at
   decode, 4 x 512 and mixtral's 2 x 4608 prompts), bit for bit and
   timed, B3 at their attention and lm_head widths, B1/B2 at
   granite-moe's heads (KV 8, G 3, D 64; B1 also paged) and B2 at
   mixtral's window of 4096 (D 128) over 2 x 4608; [granite-moe] and
   [mixtral] serve the configs at full width and 8 of their 32 layers
   (``PATH_LAYERS``) through ``drive_main_path`` (every expert product
   through B3, launched once per expert and counted); [granite-moe
   scheduler] streams 16 requests through 8 slots at drop-free capacity;
   [mixtral ring] serves 2 x 4608 prompts through its rings of 4096;
   [<moe> cpu check] holds a depth-2 copy against the CPU (granite-moe's
   on 8 requests of 16 tokens) and counts the tokens the two devices route
   to other experts: each such flip must be a router near-tie (a
   probability gap of at most ``ROUTER_NEAR_TIE``), a request is held to
   the limits only up to its first flipped position, and at least half of
   the (request, step) pairs must be held (``moe_held``);
21. the state-space decoders: [kernels] holds B3 bit for bit at every
   projection width of mamba2-780m and hymba-1.5b (M = 1, 4, 8, 128, 2048;
   the narrow outputs N = 16, 25, 48, 128 also in ``QMM_EDGES``), B1 and
   B2 at hymba's heads (KV 5, G 5, D 64) and B2 at its window of 1024 over
   2 x 2048; [mamba2] serves mamba2-780m at full width and
   ``PATH_LAYERS`` (24 of 48 layers: B3 alone, its B1 / B2 counts
   printed, both 0), [mamba2 sample] one sampled run of it; [hymba]
   serves hymba-1.5b at full width and ``PATH_LAYERS`` (16 of 32 layers:
   B1 on the global layers 0 and 15, B2 on every layer), [hymba ring] 2 x 2048 prompts through the rings of 1024 of a
   copy of its first 8 layers (``HYMBA_RING_LAYERS``: 7 rings) against
   dense caches; [<ssm> cpu check] holds a depth-2 copy against
   the CPU (hymba's keeps a global layer 0 and a windowed layer 1, window
   32);
22. the encoder-decoder and the VLM: [kernels] holds B1 and B2 at the
   heads (KV, G, D) = (16, 1, 64) of seamless-m4t-medium and (8, 7, 128)
   of llava-next-34b (int8, int4, bf16 K/V, dense and paged, the same
   rules as at D 64), and B3 bit for bit at both configs' widths (M = 1,
   4, 8, 128, 2048 and the rows of their paths) and at their frontend
   projections (frame_proj at 4 x 512 frames, mm_proj at 2 x 2880
   patches); [seamless] serves seamless-m4t-medium at full width and
   depth (12 encoder and 12 decoder layers) on 4 requests of 512 frames
   and 64 text tokens, 32 generated; [llava] serves llava-next-34b at full
   width and ``PATH_LAYERS`` of its 60 layers on 2 requests of 2880
   patches and 512 text tokens, 32 generated: each through
   ``drive_media_path`` (graphs == eager bit for bit, every B1 / B2 / B3
   launch counted, the cross cache's rows, peak memory, the resident int8
   bytes, device busy); [<arch> cpu check] holds a full-width copy of
   depth 2 against the CPU (llava's with ``CPU_MM_PATCHES`` patches);
23. sequence parallelism as the reference serves it: [kernels] holds B4
   (the partials kernel) at the heads (KV, G, D) of granite-moe (8, 3,
   64), seamless (16, 1, 64) and llava (8, 7, 128), int8 and int4, as at
   smollm's and stablelm's; each new phase serves a family's weights (its
   own phase's, no new draw) through ``ShardedEngine(sp=4)`` over dense
   caches, eagerly (``drive_sp_phase``): [sp bf16 paths <mode>] smollm-
   135m's three bf16 modes at ``SMOLLM_LAYERS`` (a float cache decodes
   through plain float32 partials: no B4), [sp speculative] the int8
   engine of [sp path] with its verify windows (plain attention over the
   whole dequantized cache, no B2; its tokens equal [sp path]'s up to a
   near-tie, windows and acceptance printed), [stablelm sp] (10 of 40
   layers: B4 at D 160), [granite-moe sp] (8 of 32), [mamba2 sp]
   (``MAMBA2_SP_LAYERS`` of 48: no attention, B3 alone), [seamless sp]
   (12 + 12 layers; its cross decode attends the first 32 of 512 frames,
   the rows a shard of the 128-row cache keeps, as in the reference) and
   [llava sp] (8 of 60); each zeroes the launch counts just before its
   timed run and reads them just after (B4 n_global x 31 x 4 over an
   int8 cache), prints prefill ms and decode ms a step, and holds a short
   request against the same sp engine on the CPU (stablelm's, granite-
   moe's and llava's through a twin of the same weights cut to ``SP_CPU_LAYERS``
   layers, llava's with ``CPU_MM_PATCHES`` patches).
24. tensor parallelism as the reference serves it: [kernels] holds B3's
   int32-accumulator branch (a shard's int8 x int8 -> int32 partial over
   its K slice, no quantize, no scale) bit for bit at the K slices of
   smollm-135m's and granite-8b's row-parallel layers (wo, down) at tp =
   ``TP`` and ``TP_WIDE``, M = ``ACC_ROWS``, and the shards' partials
   summed against one launch over the whole of K; timed warm and L2-cold
   beside its plain version, its bound and ``torch._int_mm``.  [tp path]
   serves the [main path]'s weights (smollm-135m, full width and depth) as
   ``ShardedEngine(tp=TP)`` through ``drive_tp_phase``: its captured
   programs and the eager driver bit for bit, the launch counts zeroed
   just before each run and read just after (the int32-accumulator branch
   TP times a row layer a pass: 180 a step; every other kernel as the
   unsharded run of the same prompts, B3's fused launches fewer by the
   reduces), the tokens against the unsharded engine's up to a near-tie,
   the first request against the same tp engine on the CPU, decode ms,
   prefill tokens/s and the reduces' int32 wire bytes a step printed;
   [tp scheduler] the [scheduler]'s 16 requests through 8 slots of dense
   caches, against batch-1 up to a near-tie; [granite-8b tp] and
   [seamless tp] the weights of [granite-8b path] (``PATH_LAYERS``) and
   [seamless] at ``TP_WIDE``, each bit for bit with its unsharded run.
25. rank-per-shard serving (``drive_rank_phase``): the engine of an
   earlier path written once (``ShardedEngine.save_serving``) and served
   by ``n`` spawned processes on the one card over gloo
   (``dist.ranks.run_ranks``; NCCL refuses two ranks on one device), each
   restoring its slice (``from_serving``) and serving the same prompts;
   the kernels are built before the spawn, so the ranks only load them.
   [tp ranks]: the [tp path]'s weights and prompts (smollm-135m, full
   width and depth) on ``TP`` ranks, tokens and prefill logits bit for
   bit those of the one-process ``ShardedEngine(tp=TP)``; [sp ranks]: the
   [sp path]'s engine (``SMOLLM_LAYERS``) on ``SP`` ranks, tokens bit for
   bit the [sp path]'s, and each rank's cache rows, after the prefill and
   after ``GEN`` - 1 teacher-forced steps, those of the one-process cache
   (sha-256 of each layer's K and V slice).  Each rank's launches are the
   one-process run's divided over the ranks (B3's int32-accumulator
   branch, B4), its reduces and their int32 wire bytes the one-process
   run's; printed per rank: its resident int8 weight bytes, B3-accumulator
   launches, reduces and wire bytes a decode step, the decode wall a step
   and the share of it in the collectives (gloo's host staging included).
   A rank that fails fails the script: no phase catches it.
26. [analysis] (``repro_torch.analysis``, after [tp ranks], on the [main
   path]'s engine): the sweep on the card (``run_analysis(device=
   "cuda")``: 3 variants x 6 entry points, [tp2], [sp2], the served
   thresholds, the caches, two scheduler sessions at SMOKE) with zero
   findings and as many entry points as on the CPU, every entry point's
   launch delta equal to its formula (B3 7 L a pass, B2 L a prefill pass,
   B1 L a decode step, B4 sp L, B3-acc 2 tp L, the int4 and bf16
   counters on their variants) and printed; ``Engine.analyze()`` on the
   full-width 30-layer engine with zero findings; no plain version run on
   CUDA tensors; the B5 red case (a fake-mode forward and an
   ``ops.fake_quant`` call under the recorder give
   ``freeze.fake-quant-call``, B5 launched); ``dry_run_report`` of the
   same weights as ``ShardedEngine(tp=TP)`` at B prompts: int32 all-reduces
   only, ``TP_DECODE_WIRE_BYTES`` a decode step, equal to the reduces'
   counted bytes.  [analysis sp] (after [sp path]): the [sp path]'s
   engine's ``dry_run_report``: no all-reduce, its gathered partials'
   bytes equal to the counted gathers'.
27. the float32 configs (the reference's own, built with dtype float32):
   [kernels] holds B3's float32 output (``check_quant_matmul`` at
   ``QMM_F32_ROWS``, int8 and int4 weights, smollm-135m's widths and
   granite-moe-3b-a800m's expert widths) bit for bit, and B2 over a
   float32 K/V stream (``BITS`` 32: one-shot, chunked and paged at both
   configs' heads) within ``F32_ATTN_TOL``; [float32 path int8_w_bf16_kv]
   and [float32 path bf16_w_bf16_kv] serve smollm-135m at full depth over
   a float32 cache, [float32 paged] its paged twin at
   ``F32_PAGED_LAYERS``, [granite-moe float32] ``MOE_F32_LAYERS`` layers
   over the int8 cache: graphs and ``loop=True`` bit for bit, every
   float32 launch counted, each held against the CPU.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device the script exits 1 before any of it.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

B, PROMPT, GEN = 4, 512, 32
# the reference's serving modes beside int8 weights over an int8 cache
SERVING_MODES = {"bf16_w_bf16_kv": dict(fp=True, kv_int8=False),
                 "bf16_w_int8_kv": dict(fp=True, kv_int8=True),
                 "int8_w_bf16_kv": dict(fp=False, kv_int8=False)}
# the paged path and the scheduler: chunked prefill, pages, slot batch
CHUNK, PAGE, SLOTS, BLOCK_STEPS, N_REQUESTS = 128, 64, 8, 8, 16
# the sequence-parallel paths: shards, and the scheduler's slots, requests
# and generated tokens
SP, SP_SLOTS, SP_REQUESTS, SP_GEN = 4, 4, 8, 16
# the tensor-parallel paths: smollm-135m's shards (its 9 / 3 heads and d_ff
# 1536 divide by 3), and the wider configs' (granite-8b, seamless-m4t-medium)
TP, TP_WIDE = 3, 2
# [analysis]: the int32 bytes a [tp path] decode step's reduces move
# (PERF.md §2): 2 row-parallel layers x 30 layers, each summing B x 576
# int32 from the TP - 1 other shards
TP_DECODE_WIRE_BYTES = 1_105_920
# the decoding strategies beside greedy (launch/strategies.py): the sampling
# knobs of [sample path] and [sampled scheduler], and the draft window and
# lookup n-gram of the speculative phases (a verify window of SPEC_K + 1)
SAMPLING = dict(temperature=0.7, top_p=0.9, seed=3)
SPEC_K, SPEC_NGRAM = 4, 2
SPECULATIVE = dict(decode_strategy="speculative", spec_k=SPEC_K,
                   spec_ngram=SPEC_NGRAM)
# [resilience]: one fault plan over the [scheduler]'s 16 requests
# (launch/faults.py), 10 ms a block on the virtual clock: rid 1's admission
# is rejected, rid 2's prefill and rid 3's decode (at its step 5) turn NaN,
# rid 0 (priority 1) is force-preempted at block 2, rid 13's 15 ms deadline
# expires while it is queued, rid 15 arrives at 25 ms with priority 5 and
# preempts the lowest-priority resident (rid 10), and the queue cap of 14
# sheds the 15th arrival at 0 ms (rid 14)
RESILIENCE_PLAN = dict(reject=(1,), nan_prefill=(2,), nan_decode=((3, 5),),
                       preempt=((2, 0),), ms_per_block=10.0)
RESILIENCE_EXTRA = {0: dict(priority=1), 13: dict(deadline_ms=15.0),
                    15: dict(priority=5, arrive_ms=25.0)}
RESILIENCE_QUEUE_CAP = 14
RESILIENCE_STATUS = {1: "failed", 2: "failed", 3: "failed", 13: "timeout",
                     14: "shed"}            # every other request: ok
RESILIENCE_PARKED = (0, 10)                 # re-admitted through resume
# prefix_exhausted: the paged run's 13 prefills but the NaN one (dense 0)
RESILIENCE_HEALTH = dict(ok=11, failed=3, timeout=1, shed=1, rejected=0,
                         preempted=0, preemptions=2, readmits=2,
                         deadline_misses=1, prefix_exhausted=12)
# [variants full]: the paper's FAT variants at smollm-135m's full width,
# each served in int8 (KV int8 too) with prompts of VARIANT_PROMPT tokens
VARIANT_POLICIES = {
    "vector symmetric": {},
    "vector asymmetric": dict(act_symmetric=False),
    "scalar symmetric": dict(weight_per_channel=False),
    "scalar asymmetric": dict(weight_per_channel=False, act_symmetric=False),
    "percentile": dict(observer="percentile"),
    "pointwise": dict(pointwise_scales=True),
}
# the pointwise policy's fine-tune: one FAT step a calibration batch, at
# the default rate and, beside it, at POINTWISE_LOW_LR
VARIANT_PROMPT, VARIANT_GEN, POINTWISE_STEPS = 128, 16, 3
POINTWISE_LOW_LR = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor-core peak
TF32_FLOPS_PER_S = 495e12   # dense tf32 tensor-core peak (float32 operands)
ATTN_TOL = 1e-4             # kernel vs plain attention (float32 sums reordered)
# B2 over a float32 K/V stream (3xTF32) vs its plain version: the tolerance
# of tests/test_torch_bf16.py for B2 against the reference, x (1 + max|out|)
F32_ATTN_TOL = 1e-5
# GPU vs CPU logits of the whole 30-layer bf16 model: bf16 rounds at other
# places in the two devices' norms, rotary, SiLU and readout, and the
# differences pass through 30 residual layers
LOGIT_ATOL = 0.25
# the same at int4 KV: a K/V element that the bf16 differences move across
# a rounding boundary moves by one int4 step, T/7, not T/127
LOGIT_ATOL_INT4 = 0.5
# the cut copies of the wider configs against the CPU, logits by config:
# a first difference of one bf16 step, where the two devices' float32 sums
# round to other neighbours (stablelm-12b's LayerNorm of layer 0; gemma3-
# 12b's attention at D 256 in layer 0; granite-8b's only in the final
# norm), crosses int8 steps in every later product.  Measured on an H100
# at these seeds: 0.0312, 0.3096 (2 layers), 0.3667 (6 layers).  The MoE
# copies read less: mixtral 0.0000 (its int8 readout sums exactly in
# int32, so equal inputs give equal logits), limit 0.0625, two bf16 steps
# of its largest logit (4.125); granite-moe, calibrated on the pipeline's
# batches, 0.0684 over the 24 held pairs of 4 x 32, and its sp twins
# 0.0625: as ``stage_gaps`` traces it, on the same input only layer 0's
# prefill attention (one bf16 step, 0.0039: B2 against the plain
# softmax) and the tied bf16 readout (0.0078-0.0156, its sums' order)
# differ, and the int8 products grow that step to 0.0703 at the final
# norm; limit 0.125, 1.8x, a quarter of the median |logit| that
# ``cpu_check`` prints beside it (0.53).  The
# state-space copies read 0.0156 each (mamba2, hymba: largest |logit|
# 4.031 / 4.062, median 0.527 / 0.539; their SSD's float32 einsums sum in
# other orders on the two devices): the same limit, 4x their reading.
WIDE_LOGIT_ATOL = {"granite-8b": LOGIT_ATOL, "stablelm-12b": 0.5,
                   "gemma3-12b": 0.5, "granite-moe-3b-a800m": 0.125,
                   "mixtral-8x7b": 0.0625, "mamba2-780m": 0.0625,
                   "hymba-1.5b": 0.0625}
# GPU vs CPU for the engine's first fine-tune step (bfloat16), same inputs:
# the loss's relative error, and the relative L2 error of all alpha (or all
# KV log2_t) gradients together.  Both devices round differently, and at
# the int4 KV grid an element moved across a rounding boundary moves by
# T/7 and carries on through the later layers: the engine's loss moves by
# 1.5% over two fine-tune steps that move every threshold by 0.1%, and
# even in float32 an H100 and the CPU give losses 1.9e-3 apart at full
# width.  The alpha gradients are sums of rounding residuals (y - x)/T,
# each flipped element moving its alpha's gradient by about one step
# times its incoming gradient, so they agree only roughly; a wrong
# gradient would be off by its whole norm or more.
FT_LOSS_RTOL = 2e-2
FT_GRAD_RTOL = {"alpha": 0.5, "log2_t": 0.1}


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=10):
    """Device time per call of ``fn``, summed over its kernels by
    ``torch.profiler``; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def timed(torch, fn, **kw):
    """(ms, call_ms): the kernel's device time (profiler; the CUDA-event
    time when the profiler sees no device time) and the CUDA-event time per
    call, which includes the host's launch cost when that is the larger."""
    call = cuda_ms(torch, fn, **kw)
    dev = device_ms(torch, fn)
    return (call if dev is None else dev), call


def cold_ms(torch, fn, flush, match, iters=10):
    """Device time per call of ``fn`` with the L2 cache flushed before each
    call (``flush`` writes more than the card's 50 MB of L2): the
    profiler's time of the kernels whose name holds ``match``, so the
    flush itself is not counted; CUDA events around ``fn`` alone when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match in e.key)
    if us > 0:
        return us / iters / 1e3
    total = 0.0
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def l2_flush(torch, dev):
    """A function that writes 64 MiB on the card (more than its L2)."""
    buf = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    return buf.zero_


def bound_ms(nbytes, ops, rate):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def prefill_variant(mangled):
    """'q bf16, D<=64, int8, dense' from a mangled
    ``prefill_attention_kernel<T, DCH, BITS, PAGED>`` name (BITS 16: bf16
    K/V, 32: float32 K/V)."""
    m = re.search(r"prefill_attention_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d+)"
                  r"ELb(\d)E", mangled)
    if m is None:
        return mangled
    t, dch, bits, paged = m.groups()
    kv = {"16": "bf16 K/V", "32": "f32 K/V"}.get(bits, f"int{bits}")
    return (f"q {'f32' if t == 'f' else 'bf16'}, D<={64 * int(dch)}, "
            f"{kv}, {'paged' if paged == '1' else 'dense'}")


def ptxas_resources(build, lib):
    """{mangled kernel name: (registers, spill store bytes)} from the
    ``-Xptxas=-v`` log of library ``lib``."""
    regs, spills, cur = {}, {}, None
    for line in build.ptxas_logs().get(lib, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            spills[cur] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    return {name: (regs.get(name, "?"), spills.get(name, "?"))
            for name in set(regs) | set(spills)}


def check_prefill_sass(build):
    """B2 runs on the tensor cores: every instantiation of
    ``prefill_attention_kernel`` holds HMMA instructions (cuobjdump -sass)
    and spills no register (ptxas -v); prints each one's registers and
    spills beside its count."""
    res, hmma = {}, {}
    for lib in ("prefill_attention", "prefill_attention_wide"):
        res.update(ptxas_resources(build, lib))
        hmma.update(build.sass_counts(lib, "prefill_attention_kernel",
                                      "HMMA"))
    for name, n in sorted(hmma.items(), key=lambda kv: prefill_variant(kv[0])):
        regs, spill = res.get(name, ("?", "?"))
        print(f"  prefill_attention_kernel [{prefill_variant(name)}]: {n} "
              f"HMMA, {regs} registers, spill stores {spill} bytes")
    # q bf16/f32 x D <= 64/128/192/256 x int8/int4/bf16 K/V x dense/paged,
    # D <= 128 and D > 128 in two libraries, and f32 K/V at D <= 64/128
    # (HMMA.1684 on tf32 operands)
    if len(hmma) != 56 or min(hmma.values()) == 0:
        raise AssertionError(f"prefill_attention: expected 56 instantiations, "
                             f"each with HMMA instructions; got {hmma}")
    spilled = {prefill_variant(n): r[1] for n, r in res.items()
               if "prefill_attention_kernel" in n and r[1] not in (0, "?")}
    if spilled:
        raise AssertionError(f"prefill_attention spills registers: {spilled}")
    if len(res) < len(hmma):
        print("  (registers and spills not checked: the library was built "
              "by an earlier process, whose ptxas log this one lacks)")


def decode_attn_variant(mangled):
    """'q bf16, G<=4, D<=256, int8, paged' from a mangled
    ``decode_attention_kernel<T, GMAX, DMAX, BITS, PAGED, PARTIALS>``
    name."""
    m = re.search(r"decode_attention_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)"
                  r"ELi(\d)ELb(\d)ELb(\d)E", mangled)
    if m is None:
        return mangled
    t, gmax, dmax, bits, paged, parts = m.groups()
    return (f"q {'f32' if t == 'f' else 'bf16'}, G<={gmax}, D<={dmax}, "
            f"int{bits}, {'paged' if paged == '1' else 'dense'}"
            + (", partials" if parts == "1" else ""))


def check_decode_attention_spills(build):
    """B1 and B4 (one body): every instantiation of
    ``decode_attention_kernel`` (q f32/bf16 x G <= 1/2/4/8/16 x int8/int4 x
    dense/paged, in each library: B1 and B4 at D <= 128, and their _wide
    twins at D <= 256) spills no register (ptxas -v); prints the D <= 256
    instantiations' registers."""
    for lib in ("decode_attention", "decode_attention_wide",
                "decode_attention_partials",
                "decode_attention_partials_wide"):
        res = {n: r for n, r in ptxas_resources(build, lib).items()
               if "decode_attention_kernel" in n}
        for name, (regs, spill) in sorted(
                res.items(), key=lambda kv: decode_attn_variant(kv[0])):
            if "D<=256" in decode_attn_variant(name):
                print(f"  {lib} [{decode_attn_variant(name)}]: {regs} "
                      f"registers, spill stores {spill} bytes")
        if res and len(res) != 40:
            raise AssertionError(f"{lib}: expected 40 instantiations of "
                                 f"decode_attention_kernel, got {len(res)}")
        spilled = {decode_attn_variant(n): r[1] for n, r in res.items()
                   if r[1] not in (0, "?")}
        if spilled:
            raise AssertionError(f"{lib} spills registers: {spilled}")
        if not res:
            print(f"  ({lib}: registers and spills not checked: the library "
                  "was built by an earlier process, whose ptxas log this one "
                  "lacks)")


# the x type of a mangled quant_matmul kernel name: 'a' (int8_t) is the
# int32-accumulator branch's already quantized x
X_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8 (int32 sums)"}
# the output type O: a repeated bf16 mangles as a substitution (S<n>_)
QMM_T_O = r"(13__nv_bfloat16|f|a)(13__nv_bfloat16|S\d*_|f|i)"


def qmm_out(o):
    return {"f": "f32", "i": "int32"}.get(o, "bf16")


def qmm_variant(mangled):
    """'x bf16, bf16 out, int8 weights, 64 x 128, 16-byte staging' from a
    mangled ``quant_matmul_mma_kernel<T, O, WB, BM, BN, MT, VEC>`` name."""
    m = re.search(r"quant_matmul_mma_kernelI" + QMM_T_O + r"Li(\d)ELi(\d+)"
                  r"ELi(\d+)ELi(\d)ELb(\d)E", mangled)
    if m is None:
        return mangled
    t, o, wb, bm, bn, _, vec = m.groups()
    return (f"x {X_TYPES[t]}, {qmm_out(o)} out, int{wb} weights, {bm} x "
            f"{bn}, {'16-byte' if vec == '1' else 'narrow'} staging")


def check_quant_matmul_sass(build):
    """B3's prefill kernel runs on the int8 tensor cores: every
    instantiation of ``quant_matmul_mma_kernel`` holds IMMA instructions
    (cuobjdump -sass) and spills no register (ptxas -v)."""
    res = ptxas_resources(build, "quant_matmul")
    imma = build.sass_counts("quant_matmul", "quant_matmul_mma_kernel",
                             "IMMA")
    for name, n in sorted(imma.items(), key=lambda kv: qmm_variant(kv[0])):
        regs, spill = res.get(name, ("?", "?"))
        print(f"  quant_matmul_mma_kernel [{qmm_variant(name)}]: {n} IMMA, "
              f"{regs} registers, spill stores {spill} bytes")
    # x f32/bf16 x bf16/f32 out x int8/int4 weights x 3 tiles and the
    # narrow variant, and the int32-accumulator branch's four (int8 x, int8
    # weights)
    if len(imma) != 36 or min(imma.values()) == 0:
        raise AssertionError(f"quant_matmul: expected 36 instantiations of "
                             f"quant_matmul_mma_kernel, each with IMMA "
                             f"instructions; got {imma}")
    spilled = {qmm_variant(k): v[1] for k, v in res.items()
               if "quant_matmul_mma_kernel" in k and v[1] != 0}
    if spilled:
        raise AssertionError(f"quant_matmul_mma_kernel spills: {spilled}")


def decode_variant(mangled):
    """'x bf16, bf16 out, int8 weights, M <= 4' from a mangled
    ``quant_matmul_decode_kernel<T, O, WB, MR>`` name."""
    m = re.search(r"quant_matmul_decode_kernelI" + QMM_T_O +
                  r"Li(\d)ELi(\d)E", mangled)
    if m is None:
        return mangled
    t, o, wb, mr = m.groups()
    return f"x {X_TYPES[t]}, {qmm_out(o)} out, int{wb} weights, M <= {mr}"


def decode_split(k, n, sms):
    """(BN, C) of the decode kernel for (K, N): ``launch_decode`` in
    ``csrc/quant_matmul.cu``, repeated."""
    c = 1
    while c < 4 and 2 * c * 64 <= k:
        c *= 2
    bn = 128
    while bn > 32 and -(-n // bn) * c < sms // 2:
        bn //= 2
    return bn, c


def check_quant_matmul_decode_sass(build, sms):
    """B3's decode kernel: every instantiation of
    ``quant_matmul_decode_kernel`` holds dp4a (IDP) instructions
    (cuobjdump -sass) and spills no register (ptxas -v); prints each one's
    registers, and the column tile and cluster size of each (K, N) of
    smollm-135m's layer."""
    res = ptxas_resources(build, "quant_matmul")
    idp = build.sass_counts("quant_matmul", "quant_matmul_decode_kernel",
                            "IDP")
    for name, n in sorted(idp.items(), key=lambda kv: decode_variant(kv[0])):
        regs, spill = res.get(name, ("?", "?"))
        print(f"  quant_matmul_decode_kernel [{decode_variant(name)}]: {n} "
              f"IDP, {regs} registers, spill stores {spill} bytes")
    # x f32/bf16 x bf16/f32 out x int8/int4 weights x M <= 1, 2, 4, 8, and
    # the int32-accumulator branch's four
    if len(idp) != 36 or min(idp.values()) == 0:
        raise AssertionError(f"quant_matmul: expected 36 instantiations of "
                             f"quant_matmul_decode_kernel, each with IDP "
                             f"instructions; got {idp}")
    spilled = {decode_variant(k): v[1] for k, v in res.items()
               if "quant_matmul_decode_kernel" in k and v[1] != 0}
    if spilled:
        raise AssertionError(f"quant_matmul_decode_kernel spills: {spilled}")
    for k, n in ((576, 576), (576, 192), (576, 1536), (1536, 576)):
        bn, c = decode_split(k, n, sms)
        print(f"  quant_matmul decode K={k} N={n}: column tile {bn}, "
              f"cluster of {c} blocks, {-(-n // bn) * c} blocks")


# B3's edge cases, each bit for bit against the plain version at float32
# and bf16 x: (M, K, N, w_bits, x): rows the decode kernel does not take
# (its M <= 8), ragged K and N (odd K at int8 only: int4 packs K in pairs),
# x on exact .5 ties of x * act_scale and past the clip ("ties"), and all
# +-127 at K = 1536, where |acc| > 2^24 ("sat")
QMM_EDGES = ([(m, 576, 192, wb, "ties") for m in (9, 15, 16, 17, 37, 129)
              for wb in (8, 4)]
             + [(37, k, n, wb, "ties") for k, n in ((576, 200), (100, 36))
                for wb in (8, 4)]
             + [(37, 33, 17, 8, "ties"), (37, 34, 17, 4, "ties")]
             + [(64, 1536, 576, wb, "sat") for wb in (8, 4)]
             # the SSM projections' narrow outputs: hymba's dt_proj (N 25,
             # odd: every odd bf16 output row starts 2 bytes off a 4-byte
             # boundary) and b_proj / c_proj (N 16), mamba2's dt_proj (N 48)
             # and b_proj / c_proj (N 128), at the rows of their paths
             + [(m, k, n, 8, "ties") for m in (1, 4, 8, 128, 2048)
                for k, n in ((1600, 25), (1600, 16), (1536, 48),
                             (1536, 128))]
             + [(m, 1600, 25, 4, "ties") for m in (4, 128)])
# the decode kernel's edge cases (M <= 8, K and N multiples of 4): ragged
# row counts at smollm-135m's widths and at K, N that end a cluster slice,
# a column tile or a 16-byte piece early, and one all-+-127 case
QMM_DECODE_EDGES = ([(m, k, n, wb, "ties") for m in (1, 2, 3, 5, 7, 8)
                     for k, n in ((576, 192), (1536, 576), (576, 1536),
                                  (100, 36), (4, 4), (8, 1540))
                     for wb in (8, 4)]
                    + [(8, 1536, 576, wb, "sat") for wb in (8, 4)])


def qmm_case(torch, gen, dev, m, k, n, wb, kind):
    """(x float32, w_q, w_scale, act_scale) of one edge case."""
    from repro_torch.core.packing import pack_int4

    hi = 8 if wb == 4 else 128
    if kind == "ties":   # x * 4 = i + .5 (exact in bf16 for |i| < 128)
        x = (torch.randint(-200, 200, (m, k), generator=gen,
                           device=dev) + 0.5) / 4
        act = torch.tensor(4.0, device=dev)
        w = torch.randint(-hi, hi, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
    else:                # +-127 activations, +-7 / +-127 weights
        x = torch.where(torch.rand((m, k), generator=gen, device=dev)
                        < 0.9, 300.0, -300.0)
        act = torch.tensor(1.0, device=dev)
        w = torch.where(torch.rand((k, n), generator=gen, device=dev)
                        < 0.95, hi - 1, 1 - hi).to(torch.int8)
    if wb == 4:
        w = pack_int4(w, axis=0)
    w_scale = torch.rand((n,), generator=gen, device=dev) + 0.5
    return x, w, w_scale, act


def check_quant_matmul_edges(torch, ops, ref, dev, cases=QMM_EDGES,
                             label="edge"):
    """Every case of ``cases``, float32 and bf16 x, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(19)
    for m, k, n, wb, kind in cases:
        x, w, w_scale, act = qmm_case(torch, gen, dev, m, k, n, wb, kind)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got = ops.quant_matmul(xd, w, w_scale, act, w_bits=wb)
            want = ref.quant_matmul_ref(xd, w, w_scale, act, wb)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            name = "f32" if dtype == torch.float32 else "bf16"
            print(f"  quant_matmul {label} M={m} K={k} N={n} int{wb} x "
                  f"{name} {kind}: {'bit-identical' if same else 'DIFFERS'}")
            if not same:
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"quant_matmul {label} (M={m}, K={k}, N={n}, int{wb}, x "
                    f"{name}, {kind}) differs from its plain version (max "
                    f"|diff| {diff})")


# B3's rows: decode (the decode kernel) of the main path, of the
# scheduler's slot batch and of one request, the scheduler's admission
# chunk, the paged path's chunk of 4 x 128, a whole 4 x 512 prefill, the
# speculative verify windows of generate_batch (4 x 5) and of the
# scheduler (8 x 5), on the tensor-core path
QMM_ROWS = (("decode", B), ("slot decode", SLOTS), ("decode 1", 1),
            ("admission", CHUNK), ("paged chunk", B * CHUNK),
            ("prefill", B * PROMPT), ("verify", B * (SPEC_K + 1)),
            ("slot verify", SLOTS * (SPEC_K + 1)))
# rows up to this take the decode kernel, and are also timed L2-cold
DECODE_ROWS = 8


# smollm-135m's seven B3 widths, (name, K, N)
QMM_LAYER = (("wq", 576, 576), ("wk", 576, 192), ("wv", 576, 192),
             ("wo", 576, 576), ("gate", 576, 1536), ("up", 576, 1536),
             ("down", 1536, 576))
# B3's float32 output (a float32 config's expert products): every row
# count of the paths, bit for bit; the decode and prefill rows also timed
# (a phase of None: checked, not timed)
QMM_F32_ROWS = tuple(({B: "decode", B * PROMPT: "prefill"}.get(m), m)
                     for m in (1, 4, 8, 32, 128, 512, 2048))


def check_quant_matmul(torch, ops, ref, dev, rows=QMM_ROWS, out_dtype=None,
                       w_bits=8, widths=QMM_LAYER, label=""):
    """Every (K, N) of ``widths`` (smollm-135m's layer) at each (phase, M)
    of ``rows``, bit for bit against the plain version; returns the JSON
    entries (one per row with a phase, summed over the widths; a row of
    phase None is checked, not timed).  The decode rows are timed warm
    (``ms``: back-to-back calls, the weights in L2) and cold (``cold_ms``:
    L2 flushed before each call, as in a decode step that streams 30
    layers' weights through it).  ``out_dtype`` float32: B3's float32
    output over float32 x (a float32 config's); ``w_bits`` 4: int4 weights
    packed in pairs along K."""
    from repro_torch.core.packing import pack_int4

    f32 = out_dtype == torch.float32
    out_dtype = out_dtype or torch.bfloat16
    x_dtype = torch.float32 if f32 else torch.bfloat16
    variant = f"float32 out, int{w_bits} weights, " if f32 else ""
    kernel = "quant_matmul" + ("@f32" if f32 else "") + (
        "-w4" if w_bits == 4 else "")
    lv = 127 if w_bits == 8 else 7
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush(torch, dev)
    entries = []
    for phase, m in rows:
        tot = dict(ms=0.0, call_ms=0.0, cold_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, library_ms=0.0, nbytes=0, ops=0)
        for name, k, n in widths:
            x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
                x_dtype)
            w = torch.randint(-lv, lv + 1, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            w_q = pack_int4(w, axis=0) if w_bits == 4 else w
            w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
            act_scale = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())

            def call():
                return ops.quant_matmul(x, w_q, w_scale, act_scale,
                                        w_bits=w_bits, out_dtype=out_dtype)

            got = call()
            want = ref.quant_matmul_ref(x, w_q, w_scale, act_scale, w_bits,
                                        out_dtype=out_dtype)
            torch.cuda.synchronize()
            if got.dtype != out_dtype or not torch.equal(got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"quant_matmul {label}{variant}{phase} {name} (M={m}, "
                    f"K={k}, N={n}) is not bit-exact with its plain version "
                    f"(max |diff| {diff})")
            if phase is None:
                continue
            ms, call_ms = timed(torch, call)
            cold = (cold_ms(torch, call, flush, "quant_matmul")
                    if m <= DECODE_ROWS else None)
            plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
                x, w_q, w_scale, act_scale, w_bits, out_dtype=out_dtype),
                iters=5, warmup=1)
            nbytes = (m * k * x.element_size() + k * n * w_bits // 8 + 4 * n
                      + 4 + m * n * got.element_size())
            bnd, _ = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            # yardstick: cuBLAS int8 GEMM (on the unpacked weights), not
            # called anywhere in the port; torch._int_mm needs M > 16, so
            # the decode rows are zero-padded to M = 32 (the same product,
            # plus padding)
            x_q = torch.clamp(torch.round(x.float() * act_scale), -127,
                              127).to(torch.int8)
            if m <= 16:
                x_q = torch.cat([x_q, x_q.new_zeros((32 - m, k))])
            lib, _ = timed(torch, lambda: torch._int_mm(x_q, w))
            print(f"  quant_matmul {label}{variant}{phase:11s} {name:4s} "
                  f"M={m:5d} K={k:4d} N={n:4d}: {ms * 1e3:8.1f} us (per call "
                  f"{call_ms * 1e3:6.1f} us"
                  + (f", L2-cold {cold * 1e3:.1f} us" if cold is not None else "")
                  + f")  plain {plain * 1e3:9.1f} us"
                  f"  bound {bnd * 1e3:6.2f} us  _int_mm {lib * 1e3:.1f} us"
                  + (" (M padded to 32)" if m <= 16 else ""))
            for key, v in (("ms", ms), ("call_ms", call_ms),
                           ("cold_ms", cold or 0.0), ("plain_ms", plain),
                           ("bound_ms", bnd), ("library_ms", lib),
                           ("nbytes", nbytes), ("ops", 2 * m * k * n)):
                tot[key] += v
        if phase is None:
            print(f"  quant_matmul {label}{variant}M={m}: every width "
                  "bit-exact")
            continue
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        if m <= DECODE_ROWS:
            print(f"  quant_matmul {label}{variant}{phase} M={m}: one "
                  f"layer's {len(widths)} calls {tot['ms'] * 1e3:.1f} us "
                  f"warm, {tot['cold_ms'] * 1e3:.1f} us L2-cold, bound "
                  f"{tot['bound_ms'] * 1e3:.2f} us")
        entries.append({
            "name": f"quant_matmul[{variant}{phase}: one layer's "
                    f"{len(widths)} matmuls, M={m}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": kernel, "max_abs_err": 0.0, "ms": tot["ms"],
            "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"],
            "library": "torch._int_mm" + (
                " on the unpacked weights" if w_bits == 4 else "") + (
                f", x zero-padded from M={m} to M=32" if m <= 16 else ""),
            **({"cold_ms": tot["cold_ms"]} if m <= DECODE_ROWS else {})})
    return entries


# B3's int32-accumulator branch: the row-parallel layers (wo, down) of
# smollm-135m at tp = TP and of granite-8b at tp = TP_WIDE, each shard's K
# slice, at these rows (decode 1, 4, 8, a verify window, the admission
# chunk, a 4 x 512 prefill)
ACC_ROWS = (1, B, SLOTS, B * (SPEC_K + 1), CHUNK, B * PROMPT)
ACC_LAYERS = {"smollm-135m": (TP, (("wo", 576, 576), ("down", 1536, 576))),
              "granite-8b": (TP_WIDE, (("wo", 4096, 4096),
                                       ("down", 14336, 4096)))}


def check_quant_matmul_acc(torch, ops, ref, dev):
    """B3's int32-accumulator branch at ``ACC_LAYERS``' K slices and
    ``ACC_ROWS``: each shard's partial bit for bit against its plain
    version, and the shards' partials summed equal to one launch over the
    whole of K; a layer's partials timed warm and (decode rows) L2-cold,
    beside the plain version, the bound and ``torch._int_mm`` on each
    shard's slice.  Returns the JSON entries (one per config and row
    count, summed over the two row layers' shards)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = l2_flush(torch, dev)
    entries = []
    for arch, (tp, layers) in ACC_LAYERS.items():
        for m in ACC_ROWS:
            tot = dict(ms=0.0, call_ms=0.0, cold_ms=0.0, plain_ms=0.0,
                       bound_ms=0.0, library_ms=0.0, nbytes=0, ops=0)
            for name, k, n in layers:
                x_q = torch.randint(-127, 128, (m, k), generator=gen,
                                    device=dev, dtype=torch.int8)
                w_q = torch.randint(-127, 128, (k, n), generator=gen,
                                    device=dev, dtype=torch.int8)
                kl = k // tp
                parts = []
                for i in range(tp):
                    k0, k1 = i * kl, (i + 1) * kl
                    got = ops.quant_matmul_acc(x_q, w_q, k0, k1)
                    want = ref.quant_matmul_acc_ref(x_q, w_q, k0, k1)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"quant_matmul_acc {arch} {name} shard {i} "
                            f"(M={m}, K {k0}:{k1}, N={n}) is not bit-exact "
                            f"with its plain version")
                    parts.append(got)
                full = ops.quant_matmul_acc(x_q, w_q, 0, k)
                if not torch.equal(sum(parts), full) or not torch.equal(
                        full, ref.quant_matmul_acc_ref(x_q, w_q, 0, k)):
                    raise AssertionError(
                        f"quant_matmul_acc {arch} {name} (M={m}): the "
                        f"{tp} partials do not sum to the full-K launch")
                for i in range(tp):
                    k0, k1 = i * kl, (i + 1) * kl
                    ms, call = timed(torch, lambda: ops.quant_matmul_acc(
                        x_q, w_q, k0, k1))
                    cold = (cold_ms(torch, lambda: ops.quant_matmul_acc(
                        x_q, w_q, k0, k1), flush, "quant_matmul")
                        if m <= DECODE_ROWS else None)
                    plain, _ = timed(torch, lambda: ref.quant_matmul_acc_ref(
                        x_q, w_q, k0, k1), iters=5, warmup=1)
                    nbytes = m * kl + kl * n + 4 * m * n
                    bnd, _ = bound_ms(nbytes, 2 * m * kl * n, INT8_OPS_PER_S)
                    # yardstick: cuBLAS int8 GEMM on the shard's slice, not
                    # called anywhere in the port (M > 16: rows zero-padded)
                    xs = x_q[:, k0:k1].contiguous()
                    if m <= 16:
                        xs = torch.cat([xs, xs.new_zeros((32 - m, kl))])
                    ws = w_q[k0:k1].contiguous()
                    lib, _ = timed(torch, lambda: torch._int_mm(xs, ws))
                    for key, v in (("ms", ms), ("call_ms", call),
                                   ("cold_ms", cold or 0.0),
                                   ("plain_ms", plain), ("bound_ms", bnd),
                                   ("library_ms", lib), ("nbytes", nbytes),
                                   ("ops", 2 * m * kl * n)):
                        tot[key] += v
                print(f"  quant_matmul@acc {arch} tp={tp} {name:4s} M={m:5d} "
                      f"K={k:5d} ({tp} slices of {kl}) N={n:4d}: bit-identical"
                      f" per shard, partials sum to the full-K launch")
            _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
            print(f"  quant_matmul@acc {arch} M={m}: one layer's "
                  f"{2 * tp} row partials {tot['ms'] * 1e3:.1f} us warm"
                  + (f", {tot['cold_ms'] * 1e3:.1f} us L2-cold"
                     if m <= DECODE_ROWS else "")
                  + f"; plain {tot['plain_ms'] * 1e3:.1f} us, bound "
                  f"{tot['bound_ms'] * 1e3:.2f} us ({by}), _int_mm "
                  f"{tot['library_ms'] * 1e3:.1f} us")
            entries.append({
                "name": f"quant_matmul@acc[{arch} tp={tp}: one layer's "
                        f"{2 * tp} row partials (wo, down), M={m}]",
                "route": "cuda",
                "source": "src/repro_torch/csrc/quant_matmul.cu",
                "replaces": "src/repro/kernels/quant_matmul.py:72",
                "kernel": "quant_matmul@acc", "max_abs_err": 0.0,
                "ms": tot["ms"], "call_ms": tot["call_ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": by, "library_ms": tot["library_ms"],
                "library": "torch._int_mm on each shard's slice" + (
                    f", x zero-padded from M={m} to M=32" if m <= 16
                    else ""),
                **({"cold_ms": tot["cold_ms"]} if m <= DECODE_ROWS else {})})
    return entries


def dequant_heads(torch, t, scale, groups, bits):
    """(B, S, KV, D) int8 or bf16, or (B, S, KV, D/2) packed int4 -> (B,
    KV*G, S, D) bf16 for the SDPA yardstick; a float32 stream (``bits``
    32) stays float32."""
    from repro_torch.core.packing import unpack_int4

    if bits == 4:
        t = unpack_int4(t)
    f = (t.float() * scale.reshape(1, 1, -1, 1)).to(
        torch.float32 if bits == 32 else torch.bfloat16)
    return f.permute(0, 2, 1, 3).repeat_interleave(groups, dim=1).contiguous()


# B2's edge cases: (q dtype, D, G, Sq, Sk, q_start, kv_len, window) at B = 4.
# A float32 q at the main shape; D not a multiple of 16 (8, 40, 72) and the
# widest (128); one and 64 query heads per KV head (a query tile of 64
# positions, and of one); Sq not a multiple of the tile; kv_len 0 and 1.
PREFILL_EDGES = [
    ("f32", 64, 3, 512, 512, [0, 0, 0, 0], [512] * 4, None),
    ("bf16", 8, 3, 100, 160, [0, 60, 3, 0], [100, 160, 1, 0], None),
    ("f32", 40, 1, 130, 130, [0, 0, 0, 0], [130, 77, 1, 0], 33),
    ("bf16", 128, 3, 200, 264, [64, 0, 10, 0], [264, 200, 0, 1], None),
    ("f32", 128, 64, 37, 100, [63, 0, 20, 5], [100, 37, 1, 60], 16),
    ("bf16", 24, 64, 5, 70, [65, 0, 2, 0], [70, 5, 0, 1], 3),
    ("f32", 8, 1, 70, 70, [0, 0, 0, 0], [70, 1, 0, 33], None),
    ("bf16", 72, 3, 150, 200, [0, 50, 7, 0], [150, 200, 0, 1], 64),
]
# the speculative verify window (Sq = SPEC_K + 1 queries a row, each row at
# its own q_start, over the main path's 640-position cache): kv_len =
# q_start + Sq, or 0 for an inactive slot; windows at the cache's start and
# end and across the kernel's 64-key tiles
VERIFY_EDGES = [
    ("bf16", 64, 3, 5, 640, [512, 530, 600, 0], [517, 535, 605, 0], None),
    ("bf16", 64, 3, 5, 640, [635, 127, 1, 300], [640, 132, 6, 0], None),
    ("f32", 64, 3, 5, 640, [0, 60, 64, 509], [5, 65, 69, 514], None),
]


def kv_kind(bits):
    """The K/V stream of a ``bits`` code: 8 int8, 4 packed int4, 16 bf16,
    32 float32."""
    return {8: "int8", 4: "int4 packed", 16: "bf16", 32: "float32"}[bits]


def attn_tol(bits):
    """B2's tolerance against its plain version, x (1 + max|out|), over a
    ``bits`` K/V stream."""
    return F32_ATTN_TOL if bits == 32 else ATTN_TOL


def kv_stream(torch, gen, dev, shape, bits):
    """Seeded K/V tiles of the (B, S, KV, D) ``shape``: int8 values, int4
    values packed two per byte, or (``bits`` 16 / 32) bf16 / float32 normal
    values, a float cache's."""
    from repro_torch.core.packing import pack_int4

    if bits in (16, 32):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16 if bits == 16 else torch.float32)
    lv = 127 if bits == 8 else 7
    t = torch.randint(-lv, lv + 1, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    return pack_int4(t) if bits == 4 else t


def kv_scales(torch, gen, dev, bits, kvh=3):
    """Per-head dequant scales: the int8/int4 ranges, or ones (a float
    cache: bf16, float32)."""
    if bits >= 16:
        return [torch.ones((kvh,), device=dev) for _ in range(2)]
    return [torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
            for _ in range(2)]


def check_prefill_edges(torch, ops, ref, dev, bits, gen):
    """B2 at each of ``PREFILL_EDGES`` and ``VERIFY_EDGES`` with a ``bits``
    K/V stream (16: bf16, 32: float32),
    against its plain version (``attn_tol``); a request with kv_len 0 must
    come out as exact zeros."""
    kv_bits = 8 if bits >= 16 else bits
    for dtype, d, g, sq, sk, q_start, kv_len, window in (PREFILL_EDGES
                                                         + VERIFY_EDGES):
        q = torch.randn((B, sq, 3, g, d), generator=gen, device=dev)
        if dtype == "bf16":
            q = q.to(torch.bfloat16)
        kv = [kv_stream(torch, gen, dev, (B, sk, 3, d), bits)
              for _ in range(2)]
        scales = kv_scales(torch, gen, dev, bits)
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        got = ops.prefill_attention(q, *kv, *scales, qs, kl, causal=True,
                                    window=window, kv_bits=kv_bits)
        want = ref.prefill_attention_ref(q, *kv, *scales, qs, kl,
                                         causal=True, window=window,
                                         kv_bits=kv_bits)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        case = (f"q {dtype}, D={d}, G={g}, Sq={sq}, Sk={sk}, q_start="
                f"{q_start}, kv_len={kv_len}, window={window}, "
                f"{kv_kind(bits)}")
        print(f"  prefill_attention edge case [{case}]: max|err| {e:.2e}")
        if not e <= attn_tol(bits) * (1 + want.abs().max().item()):
            raise AssertionError(f"prefill_attention disagrees with its plain "
                                 f"version at [{case}]: max |diff| {e}")
        empty = kl == 0
        if not torch.equal(got[empty], torch.zeros_like(got[empty])):
            raise AssertionError(f"prefill_attention [{case}]: a request "
                                 f"with kv_len 0 is not exact zeros")


# decode attention (B1, and B4 through its partials epilogue) edge cases:
# (q dtype, D, G, S, cur_pos of the 4 rows, layout).  "slice" reads B4 from
# positions [100, 100 + S) of a longer cache in place (B1 from a copy);
# "paged:P" reads both through a permuted block table of pages of P.  S
# past 16 chunks of 64 takes the merge's batches.
DECODE_EDGES = [
    ("f32", 64, 3, 640, [528, 0, 64, 640], "dense"),
    ("bf16", 8, 1, 100, [100, 1, 0, 63], "dense"),
    ("f32", 24, 7, 200, [200, 129, 0, 65], "dense"),
    ("bf16", 40, 2, 300, [300, 150, 0, 7], "slice"),
    ("f32", 64, 4, 384, [384, 200, 0, 5], "paged:24"),
    ("bf16", 128, 16, 1100, [1100, 1024, 1025, 0], "dense"),
    ("bf16", 128, 3, 2048, [2048, 1500, 17, 0], "paged:64"),
]


def check_decode_edges(torch, ops, ref, dev, bits, gen):
    """B1 and B4 at each of ``DECODE_EDGES`` with a ``bits``-wide K/V
    stream, against their plain versions (``ATTN_TOL``); a row with
    cur_pos 0 must come out as exact zeros (B1) and (0, -1e30, 0) (B4)."""
    from repro_torch.cache import KernelView
    from repro_torch.core.packing import pack_int4

    lv = 127 if bits == 8 else 7
    for dtype, d, g, s, cur, layout in DECODE_EDGES:
        q = torch.randn((B, 3, g, d), generator=gen, device=dev)
        if dtype == "bf16":
            q = q.to(torch.bfloat16)
        scales = [torch.rand((3,), generator=gen, device=dev) * 0.05 + 0.01
                  for _ in range(2)]
        pos = torch.tensor(cur, dtype=torch.int32, device=dev)
        if layout.startswith("paged"):
            page = int(layout.split(":")[1])
            kp, vp, table = paged_inputs(torch, dev, gen, B, s, page, bits,
                                         d=d)
            view = KernelView(kp, vp, table, page, bits)
            got = ops.decode_attention_view(q, view, *scales, pos)
            parts = ops.decode_attention_partials_view(q, view, *scales, pos)
            k, v = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
        else:
            lo = 100 if layout == "slice" else 0
            kv = [torch.randint(-lv, lv + 1, (B, s + lo + 37, 3, d),
                                generator=gen, device=dev, dtype=torch.int8)
                  for _ in range(2)]
            if bits == 4:
                kv = [pack_int4(t) for t in kv]
            kl, vl = (t[:, lo:lo + s] for t in kv)
            k, v = kl.contiguous(), vl.contiguous()
            got = ops.decode_attention(q, k, v, *scales, pos, kv_bits=bits)
            parts = ops.decode_attention_partials(q, kl, vl, *scales, pos,
                                                  kv_bits=bits)
        want = ref.decode_attention_ref(q, k, v, *scales, pos, kv_bits=bits)
        case = (f"q {dtype}, D={d}, G={g}, S={s}, cur_pos={cur}, {layout}, "
                f"int{bits}")
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version at [{case}]: max |diff| {e}")
        if not torch.equal(got[pos == 0], torch.zeros_like(got[pos == 0])):
            raise AssertionError(f"decode_attention [{case}]: a row with "
                                 "cur_pos 0 is not exact zeros")
        ep = partials_close(
            torch, f"decode_attention_partials [{case}]", parts,
            ref.decode_attention_partials_ref(q, k, v, *scales, pos, bits),
            pos)
        print(f"  decode_attention edge case [{case}]: max|err| {e:.2e}, "
              f"partials {ep:.2e}")


def head_variant(kvh, g, d):
    """The JSON key suffix and name tag of an attention geometry other than
    smollm-135m's (KV 3, G 3, D 64): the wider heads of granite-8b (D 128,
    G 4), stablelm-12b (D 160, G 4) and gemma3-12b (D 256, G 2), granite-
    moe's (D 64, G 3), hymba-1.5b's (KV 5, G 5, D 64: "@hymba"),
    seamless-m4t-medium's (KV 16, G 1, D 64: "@seamless") and llava-next-
    34b's (KV 8, G 7, D 128: "@llava")."""
    if (kvh, g, d) == (3, 3, 64):
        return "", ""
    named = {HYMBA_HEADS: "hymba",
             **{h: MEDIA_ARCHS[a] for a, h in MEDIA_HEADS.items()}}
    if (kvh, g, d) in named:
        return f"@{named[kvh, g, d]}", f", KV={kvh} G={g} D={d}"
    return f"@D{d}", f", KV={kvh} G={g} D={d}"


def check_attention(torch, ops, ref, dev, bits, kvh=3, g=3, d=64):
    """Both attention kernels at the main path's shapes with a ``bits`` K/V
    stream (8: int8, 4: int4 packed two per byte, 16 / 32: bf16 / float32
    with unit scales, which only the prefill kernel takes) and the heads
    (``kvh``, ``g``, ``d``): against their plain versions (main-path, ragged
    and windowed cases; bf16, and every stream past D 64, also with a
    float32 q; a float32 stream with a float32 q, the float32 configs', and
    a bf16 one), then timed, warm and with the L2 flushed before each call.
    The edge cases run at smollm-135m's heads (D 64)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import SPLIT

    kv_bits = 8 if bits >= 16 else bits
    cache_len = -(-(PROMPT + GEN) // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    k_scale, v_scale = kv_scales(torch, gen, dev, bits, kvh)
    dvar, dtag = head_variant(kvh, g, d)
    tag = kv_kind(bits) + dtag
    variant = {8: "", 4: "@int4", 16: "@bf16", 32: "@f32"}[bits] + dvar
    flush = l2_flush(torch, dev)

    def tiles(shape):
        return kv_stream(torch, gen, dev, shape, bits)

    def kv_bytes(n_pos):        # K and V of n_pos positions, one layer
        return 2 * B * n_pos * kvh * d * bits // 8

    entries = []

    # -- prefill: main-path shape, then ragged / windowed variants ---------
    q = torch.randn((B, PROMPT, kvh, g, d), generator=gen, device=dev).to(
        torch.float32 if bits == 32 else torch.bfloat16)
    k = tiles((B, PROMPT, kvh, d))
    v = tiles((B, PROMPT, kvh, d))
    full = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    err = 0.0
    cases = [(zero, full, None),
             (torch.tensor([0, 5, 100, 3], dtype=torch.int32, device=dev),
              torch.tensor([512, 300, 1, 0], dtype=torch.int32, device=dev),
              None),
             (zero, full, 100)]
    q_dtypes = (torch.bfloat16, torch.float32) if bits >= 16 or d > 64 else (
        torch.bfloat16,)
    for q_dtype in q_dtypes:
        for q_start, kv_len, window in cases:
            got = ops.prefill_attention(q.to(q_dtype), k, v, k_scale,
                                        v_scale, q_start, kv_len,
                                        causal=True, window=window,
                                        kv_bits=kv_bits)
            want = ref.prefill_attention_ref(q.to(q_dtype), k, v, k_scale,
                                             v_scale, q_start, kv_len,
                                             causal=True, window=window,
                                             kv_bits=kv_bits)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not e <= attn_tol(bits) * (1 + want.abs().max().item()):
                raise AssertionError(
                    f"prefill_attention ({tag}, q {q_dtype}) disagrees with "
                    f"its plain version: max |diff| {e} (window={window})")
            empty = kv_len == 0
            if not torch.equal(got[empty], torch.zeros_like(got[empty])):
                raise AssertionError(f"prefill_attention ({tag}): a request "
                                     "with kv_len 0 is not exact zeros")
            err = max(err, e)
    if d == 64:
        check_prefill_edges(torch, ops, ref, dev, bits, gen)

    def prefill():
        return ops.prefill_attention(q, k, v, k_scale, v_scale, zero, full,
                                     causal=True, kv_bits=kv_bits)

    ms, call = timed(torch, prefill)
    cold = cold_ms(torch, prefill, flush, "prefill_attention_kernel")
    plain, _ = timed(torch, lambda: ref.prefill_attention_ref(
        q, k, v, k_scale, v_scale, zero, full, causal=True, kv_bits=kv_bits),
        iters=5, warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, PROMPT, d).contiguous()
    kh = dequant_heads(torch, k, k_scale, g, bits)
    vh = dequant_heads(torch, v, v_scale, g, bits)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = (q.numel() * q.element_size() + kv_bytes(PROMPT) + 8 * kvh
              + 8 * B + q.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * d * pairs * B * kvh * g,
                       TF32_FLOPS_PER_S if bits == 32 else BF16_FLOPS_PER_S)
    print(f"  prefill_attention [{tag}] B={B} S={PROMPT} KV={kvh} G={g} "
          f"D={d}: {ms * 1e3:.1f} us warm, {cold * 1e3:.1f} us L2-cold (per "
          f"call {call * 1e3:.1f} us)  plain {plain * 1e3:.1f} us  bound "
          f"{bnd * 1e3:.2f} us  sdpa {lib * 1e3:.1f} us  max|err| {err:.2e} "
          f"over q {[str(t).split('.')[-1] for t in q_dtypes]} (tolerance "
          f"{attn_tol(bits)} x (1 + max|out|))")
    entries.append({
        "name": f"prefill_attention[{kv_kind(bits)} K/V, B={B}, S={PROMPT}"
                f"{dtag}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention" + variant, "max_abs_err": err, "ms": ms,
        "cold_ms": cold, "call_ms": call, "plain_ms": plain, "bound_ms": bnd,
        "bound_by": by, "library_ms": lib,
        **({"library": "SDPA on the same float32 q and K/V"}
           if bits == 32 else {})})
    if bits >= 16:
        return entries      # the decode kernels read quantized tiles only

    # -- decode: mid-generation position, then ragged positions incl. 0 and
    # the chunk boundaries; then the same rows in a longer cache ------------
    cur = PROMPT + GEN // 2
    qd = torch.randn((B, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc = tiles((B, cache_len, kvh, d))
    vc = tiles((B, cache_len, kvh, d))
    pos = torch.full((B,), cur, dtype=torch.int32, device=dev)
    cases = [pos] + [torch.tensor(c, dtype=torch.int32, device=dev) for c in (
        [0, 1, 300, cache_len], [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT],
        [cache_len - SPLIT, cache_len - 1, 2 * SPLIT - 1, 2 * SPLIT + 1])]
    long_len = 1024
    kl, vl = (torch.cat([t, tiles((B, long_len - cache_len, kvh, d))], 1)
              for t in (kc, vc))
    err = 0.0
    for cur_pos in cases:
        got = ops.decode_attention(qd, kc, vc, k_scale, v_scale, cur_pos,
                                   kv_bits=bits)
        want = ref.decode_attention_ref(qd, kc, vc, k_scale, v_scale,
                                        cur_pos, kv_bits=bits)
        longer = ops.decode_attention(qd, kl, vl, k_scale, v_scale, cur_pos,
                                      kv_bits=bits)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"decode_attention ({tag}) disagrees with "
                                 f"its plain version at cur_pos "
                                 f"{cur_pos.tolist()}: max |diff| {e}")
        if not torch.equal(got, longer):
            raise AssertionError(
                f"decode_attention ({tag}) at cur_pos {cur_pos.tolist()} "
                f"differs between caches of {cache_len} and {long_len} "
                f"positions holding the same rows: max |diff| "
                f"{(got - longer).abs().max().item()}")
        err = max(err, e)
    if d == 64:
        check_decode_edges(torch, ops, ref, dev, bits, gen)

    def decode():
        return ops.decode_attention(qd, kc, vc, k_scale, v_scale, pos,
                                    kv_bits=bits)

    ms, call = timed(torch, decode)
    cold = cold_ms(torch, decode, flush, "decode_attention_kernel")
    plain, _ = timed(torch, lambda: ref.decode_attention_ref(
        qd, kc, vc, k_scale, v_scale, pos, kv_bits=bits))
    qh = qd.reshape(B, kvh * g, 1, d)
    kh = dequant_heads(torch, kc[:, :cur], k_scale, g, bits)
    vh = dequant_heads(torch, vc[:, :cur], v_scale, g, bits)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    nbytes = (qd.numel() * 2 + kv_bytes(cur) + 8 * kvh + 4 * B
              + qd.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * B * kvh * g * cur * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention [{tag}] B={B} cache={cache_len} cur_pos={cur}: "
          f"{ms * 1e3:.1f} us warm, {cold * 1e3:.1f} us L2-cold (per call "
          f"{call * 1e3:.1f} us)  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e} over {len(cases)} cur_pos "
          f"cases incl. the chunk boundaries of {SPLIT} (tolerance "
          f"{ATTN_TOL} x (1 + max|out|)); caches of {cache_len} and "
          f"{long_len} bit-identical")
    entries.append({
        "name": f"decode_attention[{kv_kind(bits)} K/V, B={B}, cur_pos={cur}"
                f"{dtag}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "kernel": "decode_attention" + variant, "max_abs_err": err, "ms": ms,
        "cold_ms": cold, "call_ms": call, "plain_ms": plain, "bound_ms": bnd,
        "bound_by": by, "library_ms": lib, "split": SPLIT})
    return entries


# the attention heads of the wider dense configs: (KV, G, D)
WIDE_HEADS = {"granite-8b": (8, 4, 128), "stablelm-12b": (8, 4, 160),
              "gemma3-12b": (8, 2, 256)}
# gemma3-12b's local layers: a sliding window of WINDOW keys; [gemma3-12b
# ring] serves RING_B prompts of RING_PROMPT tokens
WINDOW, RING_B, RING_PROMPT = 1024, 2, 2048


def check_wide_f32_refused(torch, ops, dev):
    """B2's wide library (D > 128) has no float32 K/V branch (ROADMAP
    Queue B): a float32 K/V launch at each wide head dim past 128
    (stablelm-12b's 160, gemma3-12b's 256) raises a
    ``TypeError`` naming Queue B before any launch, and runs no plain
    version."""
    for kvh, g, d in (h for h in WIDE_HEADS.values() if h[2] > 128):
        q = torch.zeros((1, 64, kvh, g, d), device=dev)
        kv = torch.zeros((1, 64, kvh, d), device=dev)
        one = torch.ones((kvh,), device=dev)
        before = (ops.launch_counts()["prefill_attention"],
                  ops.plain_call_count())
        try:
            ops.prefill_attention(q, kv, kv, one, one, 0, 64)
        except TypeError as err:
            if "Queue B" not in str(err):
                raise AssertionError(f"D={d}: {err}")
            print(f"  prefill_attention [float32 K/V, D={d}]: refused: {err}")
        else:
            raise AssertionError(f"prefill_attention at D={d} took float32 "
                                 "K/V: the wide library has no such branch")
        if (ops.launch_counts()["prefill_attention"],
                ops.plain_call_count()) != before:
            raise AssertionError("a refused float32 K/V call launched or ran "
                                 "a plain version")


def check_window_prefill(torch, ops, ref, dev, heads=WIDE_HEADS["gemma3-12b"],
                         b=RING_B, s=RING_PROMPT, window=WINDOW,
                         key="prefill_attention@window"):
    """B2 at a sliding-window layer's prompt: by default gemma3-12b's local
    layers (D 256, G 2, KV 8, window 1024 over 2 prompts of 2048 int8
    keys); mixtral-8x7b's are (KV 8, G 4, D 128), window 4096 over 2 x
    4608.  Against its plain version (``ATTN_TOL``); timed warm and
    L2-cold beside the plain version, SDPA with the band mask and the bound
    (the keys each query sees).  Returns the JSON entry (kernel ``key``)."""
    import torch.nn.functional as F

    kvh, g, d = heads
    gen = torch.Generator(device=dev).manual_seed(29)
    k_scale, v_scale = kv_scales(torch, gen, dev, 8, kvh)
    q = torch.randn((b, s, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (kv_stream(torch, gen, dev, (b, s, kvh, d), 8) for _ in range(2))
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)

    def kernel():
        return ops.prefill_attention(q, k, v, k_scale, v_scale, zero, full,
                                     causal=True, window=window)

    def plain():
        return ref.prefill_attention_ref(q, k, v, k_scale, v_scale, zero,
                                         full, causal=True, window=window)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= ATTN_TOL * (1 + want.abs().max().item()):
        raise AssertionError(f"prefill_attention (window {window}, D {d}) "
                             f"disagrees with its plain version: max |diff| "
                             f"{err}")
    del got, want
    ms, call = timed(torch, kernel)
    cold = cold_ms(torch, kernel, l2_flush(torch, dev),
                   "prefill_attention_kernel")
    plain_ms, _ = timed(torch, plain, iters=2, warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, d).contiguous()
    kh = dequant_heads(torch, k, k_scale, g, 8)
    vh = dequant_heads(torch, v, v_scale, g, 8)
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                             < window)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=band))
    pairs = int(band.sum())
    nbytes = q.numel() * 2 + 2 * b * s * kvh * d + 8 * kvh + 8 * b + \
        q.numel() * 4
    bnd, by = bound_ms(nbytes, 4 * d * pairs * b * kvh * g, BF16_FLOPS_PER_S)
    print(f"  prefill_attention [int8, window {window}, KV={kvh} G={g} D={d}] "
          f"B={b} S={s}: {ms * 1e3:.1f} us warm, {cold * 1e3:.1f} us L2-cold "
          f"(per call {call * 1e3:.1f} us)  plain {plain_ms * 1e3:.1f} us  "
          f"bound {bnd * 1e3:.2f} us ({by})  sdpa (band mask) {lib * 1e3:.1f}"
          f" us  max|err| {err:.2e}")
    return {
        "name": f"prefill_attention[int8 K/V, window {window}, B={b}, S={s}, "
                f"KV={kvh} G={g} D={d}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": key, "max_abs_err": err, "ms": ms,
        "cold_ms": cold, "call_ms": call, "plain_ms": plain_ms,
        "bound_ms": bnd, "bound_by": by, "library_ms": lib,
        "library": "SDPA on the dequantized bf16 K/V, band mask"}


def layer_widths(cfg):
    """(name, K, N) of one layer's quantized Dense matmuls (seven in an
    attention layer; the four of attention in an MoE layer, whose experts
    ``expert_widths`` gives; a Mamba2 mixer's six, hymba's beside its
    attention and MLP; attention and the GELU MLP's fc1 / fc2 in an
    encoder-decoder, whose decoder layers run the attention widths twice,
    self and cross), and the untied lm_head's."""
    d, hd = cfg.d_model, cfg.head_dim
    out = []
    if cfg.kind != "mamba":
        out += [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
                ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d)]
    if cfg.kind in ("mamba", "hybrid"):
        di = cfg.ssm_expand * d
        heads = cfg.ssm_heads or di // cfg.ssm_head_dim
        gn = cfg.ssm_groups * cfg.ssm_state
        out += [("z_proj", d, di), ("x_proj", d, di), ("b_proj", d, gn),
                ("c_proj", d, gn), ("dt_proj", d, heads),
                ("out_proj", di, d)]
    if cfg.ffn == "gelu":
        out += [("fc1", d, cfg.d_ff), ("fc2", cfg.d_ff, d)]
    elif cfg.ffn not in ("moe", "none"):
        out += [("gate", d, cfg.d_ff), ("up", d, cfg.d_ff),
                ("down", cfg.d_ff, d)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", d, cfg.vocab_padded))
    return out


def expert_widths(cfg):
    """(name, K, N, x dtype) of one expert's three products: gate and up
    read the bf16 dispatch buffer, down the float32 product that the
    reference quantizes unrounded."""
    d, f = cfg.d_model, cfg.d_ff
    return [("gate", d, f, "bfloat16"), ("up", d, f, "bfloat16"),
            ("down", f, d, "float32")]


# B3 at the wider configs: rows checked bit for bit, and the rows timed
WIDE_QMM_ROWS = (4, 1, 8, 128, B * PROMPT)
WIDE_QMM_TIMED = (("decode", B), ("prefill", B * PROMPT))

# the mixture-of-experts configs (ROADMAP item 17 step 4), at full width:
# granite-moe-3b-a800m at full depth; mixtral-8x7b at 8 of its 32 layers
# (its bf16 weights, 93 GB at full depth, are drawn on the card before
# the int8 conversion; 8 layers hold ~24 GB of them and ~12 GB of int8)
MOE_ARCHS = {"granite-moe-3b-a800m": "granite-moe", "mixtral-8x7b": "mixtral"}
# granite-moe's heads (KV 8, G 3, D 64); mixtral's are granite-8b's
MOE_HEADS = (8, 3, 64)
# [mixtral ring]: MIXTRAL_RING_B prompts of MIXTRAL_RING_PROMPT tokens pass
# the window of 4096 on every layer, in prefill and in every decode step
MIXTRAL_RING_B, MIXTRAL_RING_PROMPT = 2, 4608
# the script's time.  With the state-space phases it ran 1105.0 and
# 1253.4 s of its 1200 on an H100 at 700 W (two runs; the machines'
# speeds differ by 10-40%), so the earlier paths serve cut depths, full
# width: the wider configs' paths and rings ``PATH_LAYERS`` (mixtral-
# 8x7b's 93 GB of bf16 weights at full depth do not fit the card either;
# ROADMAP 17b), the
# smollm-135m engines of the bf16 modes, the paged paths, the schedulers,
# resilience and recovery, sp, the variants, int4 and the main engine's
# strategies ``SMOLLM_LAYERS`` of 30 (the int8 main path and its CPU
# check, [tp path], [tp ranks] and training keep all 30),
# [granite-moe scheduler] MOE_SCHEDULER_LAYERS of its 8, [hymba ring]
# HYMBA_RING_LAYERS of 32 (layer 0 global, the rest rings); the [<arch>
# cpu check]s teacher-force ``CPU_CHECK_STEPS`` steps (mixtral's CPU twin
# streams 2.8 GB of int8 experts through float64 products a step; the
# dense copies' readouts of 49-262 k entries took 14.5-34.6 s for 8).
# With the rank phases it ran 909.2 and 951.3 s of command on two H100
# machines, and past 1200 s on a third (943.9 s on a fourth after the
# first cuts), so the variants, int4, the main engine's strategies and
# [tp scheduler], the state-space paths (half their depth), [granite-moe
# scheduler] (4 of 8 layers) and [stablelm sp]'s CPU check (a depth-2
# twin) were cut too, and the _wide kernels compile beside the first
# kernel checks
PATH_LAYERS = {"granite-8b": 10, "stablelm-12b": 10, "gemma3-12b": 12,
               "granite-moe-3b-a800m": 8, "mixtral-8x7b": 8}
SMOLLM_LAYERS = 10
# the bare gloo all_reduces each rank of [tp ranks] / [sp ranks] times;
# the ranks' deadline from their spawn (a hung collective fails the run
# here, not at the process group's own timeout)
GLOO_REPS = 50
RANK_TIMEOUT_S = 240
MOE_SCHEDULER_LAYERS = 4
HYMBA_RING_LAYERS = 8
MOE_ALONE = 2
CPU_CHECK_STEPS = {"mixtral-8x7b": 2, "granite-8b": 4, "stablelm-12b": 4,
                   "gemma3-12b": 4}


# the state-space configs (ROADMAP item 17 steps 5-6), at full width and
# PATH_LAYERS: mamba2-780m (24 of its 48 Mamba2 layers, no attention) and
# hymba-1.5b (16 of its 32 layers of attention and Mamba2 heads side by
# side; window 1024 on all but layers 0 and 15); [hymba ring] serves RING_B x RING_PROMPT prompts,
# which pass the window
SSM_ARCHS = {"mamba2-780m": "mamba2", "hymba-1.5b": "hymba"}
HYMBA_HEADS = (5, 5, 64)
PATH_LAYERS.update({"mamba2-780m": 24, "hymba-1.5b": 16})

# the encoder-decoder and the VLM (ROADMAP item 17 steps 7-8), at full
# width: seamless-m4t-medium at full depth (12 + 12 layers), on
# SEAMLESS_B requests of SEAMLESS_FRAMES frames and SEAMLESS_TEXT tokens
# (the decoder's cache of 128 positions keeps the first 128 frames for
# decode, as the reference does); llava-next-34b at ``PATH_LAYERS`` of its
# 60 layers (its bf16 and int8 copies at full depth, ~100 GB, do not fit
# the card: ROADMAP 17b), on LLAVA_B requests of its 2880 patches and
# LLAVA_TEXT tokens, calibrated on batches of LLAVA_CALIB_B x (2880 + 64)
# (the reference's default calibration length of 32 does not reach 2880
# patches); the depth-2 copy of [llava cpu check] takes CPU_MM_PATCHES
# patches (2 x 2944 positions at width 7168 are too slow for the CPU).
# Their copies' logits against the CPU: seamless 0.125, 2x its reading of
# 0.0625 on an H100; llava's [llava cpu check] 0.25, 1.3x its reading of
# 0.1897, and its [llava sp] twin 0.5 (SP_LOGIT_ATOL), 1.5x that twin's
# readings 0.3164 and 0.3281 (sharded and unsharded, other weights), each
# traced by
# ``stage_gaps``: mm_proj, the pre_norms and the lm_head add nothing on
# the same input, an attention or the final norm one bf16 step (0.0039:
# B2 or the plain float32 attention against the CPU's softmax; a decode
# step's first difference can be half of one, 0.0020), layer 1's ffn
# 0.0391 (its norm or SiLU), and the int8 activations of the 7168- and
# 20480-wide products grow those steps through whole int8 steps: in the
# sp twin's step 3, 0.0020 after layer 0's attention, 0.1055 after its
# ffn, 0.2734 after layer 1's, 0.3164 in the logits.  Every stage's own
# difference must stay within STAGE_LOCAL_ATOL, 2x the largest (0.0391)
MEDIA_ARCHS = {"seamless-m4t-medium": "seamless", "llava-next-34b": "llava"}
MEDIA_HEADS = {"seamless-m4t-medium": (16, 1, 64),
               "llava-next-34b": (8, 7, 128)}
SEAMLESS_B, SEAMLESS_FRAMES, SEAMLESS_TEXT = 4, 512, 64
LLAVA_B, LLAVA_TEXT, LLAVA_CALIB_B = 2, 512, 2
CPU_MM_PATCHES, CPU_FRAMES = 64, 256
PATH_LAYERS["llava-next-34b"] = 8
CPU_CHECK_STEPS["llava-next-34b"] = 4
WIDE_LOGIT_ATOL.update({"seamless-m4t-medium": 0.125,
                        "llava-next-34b": 0.25})
# the sp phases' limits where they read more than the copies above
SP_LOGIT_ATOL = {"llava-next-34b": 0.5}
STAGE_LOCAL_ATOL = 0.08

# the MoE copies' CPU checks: a routing choice that the card and the CPU
# make otherwise must be a near-tie of the router, its k-th and (k+1)-th
# probabilities at most ROUTER_NEAR_TIE apart (flips were seen at gaps up
# to 6.08e-4 on an H100 at 700 W); a request's logits and tokens are held
# to the limits only up to the position of its first flip (past it the
# two devices run other experts); at least half of the (request, step)
# pairs must be held.  granite-moe's copy serves MOE_CPU_REQUESTS
# requests of MOE_CPU_PROMPT tokens: over the pipeline's calibration one
# request of 64 tokens had 2 of 142 choices flipped, the first in its
# prompt (0 of 8 pairs held), and 4 x 32 one of 312, in the prompt of one
# request (24 of 32 held); mixtral's copy one of 64 (its CPU twin's
# experts are slow)
ROUTER_NEAR_TIE = 1e-3
MOE_CPU_REQUESTS = {"granite-moe-3b-a800m": 4, "mixtral-8x7b": 1}
MOE_CPU_PROMPT = {"granite-moe-3b-a800m": 32, "mixtral-8x7b": 64}

# the sequence-parallel phases of every family the reference's
# ShardedEngine(sp > 1) serves, each ShardedEngine(sp=SP) over the weights
# of the family's own phase: smollm-135m's bf16 modes and its speculative
# window at SMOLLM_LAYERS, stablelm-12b and granite-moe at PATH_LAYERS,
# mamba2 at its first MAMBA2_SP_LAYERS layers, seamless at full depth,
# llava at PATH_LAYERS; each holds its timed run's first request against
# the same sp engine on the CPU over SP_CPU_STEPS teacher-forced steps,
# but stablelm, granite-moe and llava, which hold theirs against the
# card's plain versions and a short request (1 x SP_CPU_PROMPT tokens
# with CPU_MM_PATCHES patches; the MoE copy's requests) on the CPU through
# their first SP_CPU_LAYERS layers, the depth of their [<arch> cpu check]
# copies: at 8 layers granite-moe's routers part past ROUTER_NEAR_TIE
# (33 of 536 choices over 1 x 64, gaps up to 1.87e-3) and llava's
# logits by 0.5151 (an H100 at 700 W), 2 x 3392 positions at width 7168
# take the CPU minutes, and stablelm's first request at 10 layers, traced
# on both devices sharded and unsharded, took 140.9 s of the script's
# time (its logits 0.4746 apart; no stage's own gap past 0.0430)
MAMBA2_SP_LAYERS = 12
SP_CPU_PROMPT, SP_CPU_STEPS, SP_CPU_LAYERS = 64, 4, 2


def path_config(get_config, arch):
    """The config a wider config's [<arch> path] (and its ring) serves: full
    width, and full depth but where ``PATH_LAYERS`` cuts it."""
    cfg = get_config(arch)
    return cfg.replace(n_layers=PATH_LAYERS.get(arch, cfg.n_layers))


def cut_engine(Engine, build_model, engine, n_layers, **over):
    """The engine's first ``n_layers`` layers (their weights and
    thresholds, the final norm and the readout), with ``over`` replacing
    config fields; the same device, mode and cache layout."""
    cfg = engine.cfg.replace(n_layers=n_layers, **over)
    stack = engine.serve_params["stack"]
    params = {**engine.serve_params, "stack": {
        **{f"layer{i}": stack[f"layer{i}"] for i in range(n_layers)},
        "final_norm": stack["final_norm"]}}
    return Engine(build_model(cfg), cfg, engine.policy, params,
                  engine.qparams, device=engine.device, mode=engine.mode,
                  cache_layout=engine.cache_layout)


def expert_rows(cfg):
    """(phase, M) of one expert's B3 calls on each MoE path: M = groups x
    capacity (a decode step: B groups of one token, capacity 8; 4 x 512
    prompts; mixtral's 2 x 4608 ring prompts)."""
    from repro_torch.models.moe import MoE

    moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, path="m",
              capacity_factor=cfg.capacity_factor)
    rows = [("decode", B * moe.capacity(1)),
            ("prefill", B * moe.capacity(PROMPT))]
    if cfg.window_all:
        rows.append(("ring prefill",
                     MIXTRAL_RING_B * moe.capacity(MIXTRAL_RING_PROMPT)))
    return rows


def check_quant_matmul_experts(torch, ops, ref, dev, arch, cfg,
                               out_dtype=None):
    """B3 at an MoE config's expert products, one expert's three calls
    (the path runs them once per expert, ``n_experts`` x 3 launches a
    layer and pass) at each row count of ``expert_rows``: bit for bit
    against the plain version (gate and up on bf16 x, down on float32 x,
    writing into its slice of the layer's (E, M, N) output as the path
    does), timed warm and L2-cold beside the plain version, torch._int_mm
    and the bound.  ``out_dtype`` float32: the float32 config's products
    (every x float32, B3's float32 output).  The reference's expert
    product is an XLA einsum with no ``pallas_call``; the port runs it
    through B3.  Returns the JSON entries, one per row."""
    f32 = out_dtype == torch.float32
    out_dtype = out_dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(37)
    flush = l2_flush(torch, dev)
    entries = []
    for phase, m in expert_rows(cfg):
        tot = dict(ms=0.0, call_ms=0.0, cold_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, library_ms=0.0, nbytes=0, ops=0)
        for name, k, n, xdt in expert_widths(cfg):
            xdt = "float32" if f32 else xdt
            x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
                getattr(torch, xdt))
            # a quarter of the rows zero, as the dispatch buffer's unfilled
            # slots read the zero sentinel row
            x[torch.arange(m, device=dev) % 4 == 3] = 0
            w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8)
            w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
            act_scale = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())
            out = torch.empty((2, m, n), dtype=out_dtype, device=dev)
            got = ops.quant_matmul(x, w_q, w_scale, act_scale, out=out[1])
            want = ref.quant_matmul_ref(x, w_q, w_scale, act_scale,
                                        out_dtype=out_dtype)
            torch.cuda.synchronize()
            if got.data_ptr() != out[1].data_ptr() or not torch.equal(
                    got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"quant_matmul {arch} expert {name} (M={m}, K={k}, N={n},"
                    f" x {xdt}) is not bit-exact with its plain version (max "
                    f"|diff| {diff})")
            del want

            def call():
                return ops.quant_matmul(x, w_q, w_scale, act_scale,
                                        out=out[1])

            ms, call_ms = timed(torch, call)
            cold = cold_ms(torch, call, flush, "quant_matmul")
            plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
                x, w_q, w_scale, act_scale, out_dtype=out_dtype), iters=2,
                warmup=1)
            nbytes = (m * k * x.element_size() + k * n + 4 * n + 4
                      + m * n * out.element_size())
            bnd, _ = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            x_q = torch.clamp(torch.round(x.float() * act_scale), -127,
                              127).to(torch.int8)
            lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_q))
            print(f"  quant_matmul {arch} expert {phase} {name:4s} M={m:5d} "
                  f"K={k:5d} N={n:5d} (x {xdt}): {ms * 1e3:8.1f} us, L2-cold "
                  f"{cold * 1e3:.1f} us (per call {call_ms * 1e3:.1f} us)  "
                  f"plain {plain * 1e3:9.1f} us  bound {bnd * 1e3:7.2f} us  "
                  f"_int_mm {lib * 1e3:.1f} us")
            for key, v in (("ms", ms), ("call_ms", call_ms), ("cold_ms", cold),
                           ("plain_ms", plain), ("bound_ms", bnd),
                           ("library_ms", lib), ("nbytes", nbytes),
                           ("ops", 2 * m * k * n)):
                tot[key] += v
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        per_layer = 3 * cfg.n_experts
        print(f"  quant_matmul {arch} experts {phase} M={m}: every width "
              f"bit-exact; one expert's 3 calls {tot['ms'] * 1e3:.1f} us warm,"
              f" {tot['cold_ms'] * 1e3:.1f} us L2-cold, bound "
              f"{tot['bound_ms'] * 1e3:.2f} us ({by}); a layer launches "
              f"{per_layer} (x {cfg.n_experts} experts)")
        entries.append({
            "name": f"quant_matmul[{arch} experts {phase}"
                    f"{', float32 out' if f32 else ''}: one expert's 3 "
                    f"matmuls, M={m}; {per_layer} launches a layer]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "replaces_note": "the reference's expert product is the XLA "
                             "einsum of src/repro/core/api.py:402, no "
                             "pallas_call",
            "kernel": f"quant_matmul@{'f32@' if f32 else ''}{arch}",
            "max_abs_err": 0.0, "ms": tot["ms"], "cold_ms": tot["cold_ms"],
            "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"],
            "library": "torch._int_mm on the quantized rows"})
    return entries


def check_quant_matmul_widths(torch, ops, ref, dev, arch, cfg, sms,
                              extra_rows=()):
    """B3 at one wider config's (K, N) pairs: bit for bit against its plain
    version at every row count of ``WIDE_QMM_ROWS``, each width's decode
    column tile and cluster printed (``decode_split``); one layer's calls
    (and the lm_head, timed on its own, at the decode rows, where the
    serving path runs it) timed at the decode rows (warm and L2-cold) and
    at the prefill rows beside the plain version, torch._int_mm and the
    bound.  Returns the JSON entries, one per timed row."""
    gen = torch.Generator(device=dev).manual_seed(31)
    flush = l2_flush(torch, dev)
    widths = layer_widths(cfg)
    for name, k, n in widths:
        bn, c = decode_split(k, n, sms)
        print(f"  quant_matmul {arch} {name} K={k} N={n}: decode column tile "
              f"{bn}, cluster of {c} blocks, {-(-n // bn) * c} blocks")
    entries = []
    timed_rows = dict(WIDE_QMM_TIMED)
    n_calls = sum(name != "lm_head" for name, _, _ in widths)
    for m in WIDE_QMM_ROWS + tuple(extra_rows):
        phase = {v: k for k, v in timed_rows.items()}.get(m)
        tot = dict(ms=0.0, call_ms=0.0, cold_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, library_ms=0.0, nbytes=0, ops=0)
        for name, k, n in widths:
            x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8)
            w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
            act_scale = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())
            got = ops.quant_matmul(x, w_q, w_scale, act_scale)
            want = ref.quant_matmul_ref(x, w_q, w_scale, act_scale)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"quant_matmul {arch} {name} (M={m}, K={k}, N={n}) is not "
                    f"bit-exact with its plain version (max |diff| {diff})")
            del want
            if phase is None or (name == "lm_head" and m > DECODE_ROWS):
                continue
            ms, call = timed(torch, lambda: ops.quant_matmul(
                x, w_q, w_scale, act_scale))
            cold = (cold_ms(torch, lambda: ops.quant_matmul(
                x, w_q, w_scale, act_scale), flush, "quant_matmul")
                if m <= DECODE_ROWS else None)
            plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
                x, w_q, w_scale, act_scale), iters=2, warmup=1)
            nbytes = m * k * 2 + k * n + 4 * n + 4 + m * n * 2
            bnd, _ = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            x_q = torch.clamp(torch.round(x.float() * act_scale), -127,
                              127).to(torch.int8)
            if m <= 16:
                x_q = torch.cat([x_q, x_q.new_zeros((32 - m, k))])
            # torch._int_mm takes N a multiple of 8 only (hymba's dt_proj
            # has 25 columns): zero columns pad the yardstick's weights
            w_lib = (w_q if n % 8 == 0 else torch.cat(
                [w_q, w_q.new_zeros((k, -n % 8))], dim=1))
            lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_lib))
            print(f"  quant_matmul {arch} {phase} {name:7s} M={m:5d} K={k:5d} "
                  f"N={n:6d}: {ms * 1e3:8.1f} us"
                  + (f", L2-cold {cold * 1e3:.1f} us" if cold is not None
                     else "")
                  + f"  plain {plain * 1e3:9.1f} us  bound {bnd * 1e3:7.2f} us"
                  f"  _int_mm {lib * 1e3:.1f} us"
                  + (" (M padded to 32)" if m <= 16 else "")
                  + (f" (N padded to {n + -n % 8})" if n % 8 else ""))
            if name == "lm_head":
                entries.append({
                    "name": f"quant_matmul[{arch} lm_head, M={m}, K={k}, "
                            f"N={n}]",
                    "route": "cuda",
                    "source": "src/repro_torch/csrc/quant_matmul.cu",
                    "replaces": "src/repro/kernels/quant_matmul.py:72",
                    "kernel": f"quant_matmul@{arch}", "max_abs_err": 0.0,
                    "ms": ms, "cold_ms": cold, "call_ms": call,
                    "plain_ms": plain, "bound_ms": bnd,
                    "bound_by": bound_ms(nbytes, 2 * m * k * n,
                                         INT8_OPS_PER_S)[1],
                    "library_ms": lib,
                    "library": f"torch._int_mm on x zero-padded from M={m} "
                               "to M=32"})
                continue
            tot["ms"] += ms
            tot["call_ms"] += call
            tot["cold_ms"] += cold or 0.0
            tot["plain_ms"] += plain
            tot["bound_ms"] += bnd
            tot["nbytes"] += nbytes
            tot["ops"] += 2 * m * k * n
            tot["library_ms"] += lib
        print(f"  quant_matmul {arch} M={m}: every width bit-exact")
        if phase is None:
            continue
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        print(f"  quant_matmul {arch} {phase} M={m}: one layer's {n_calls} "
              f"calls "
              f"{tot['ms'] * 1e3:.1f} us warm"
              + (f", {tot['cold_ms'] * 1e3:.1f} us L2-cold"
                 if m <= DECODE_ROWS else "")
              + f", bound {tot['bound_ms'] * 1e3:.2f} us")
        entries.append({
            "name": f"quant_matmul[{arch} {phase}: one layer's {n_calls} "
                    f"matmuls, M={m}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": f"quant_matmul@{arch}", "max_abs_err": 0.0,
            "ms": tot["ms"], "call_ms": tot["call_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": by, "library_ms": tot["library_ms"],
            "library": "torch._int_mm" + (
                f" on x zero-padded from M={m} to M=32" if m <= 16 else "")
                + (", weights of N not a multiple of 8 zero-padded" if any(
                    n % 8 for _, _, n in widths) else ""),
            **({"cold_ms": tot["cold_ms"]} if m <= DECODE_ROWS else {})})
    return entries


def paged_inputs(torch, dev, gen, b, cap, page, bits, kvh=3, d=64):
    """K/V pools (int8, packed int4 or, ``bits`` 16, bf16) of ``b`` rows of
    ``cap`` positions in pages of ``page`` (and two spare pages), with a
    seeded permuted block table in which rows 0 and 1 share their first
    page (a shared prefix page)."""
    nb = cap // page
    pages = b * nb + 2
    kp, vp = (kv_stream(torch, gen, dev, (pages, page, kvh, d), bits)
              for _ in range(2))
    perm = torch.randperm(pages, generator=gen, device=dev)
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    table[1, 0] = table[0, 0]
    return kp, vp, table.contiguous()


def check_paged_attention(torch, ops, ref, dev, bits, page, kvh=3, g=3,
                          d=64):
    """Both attention kernels over a paged pool: the scheduler's decode shape
    (8 slots, cache 640, ragged positions including 0) and the paged path's
    prefill chunk (4 rows, 128 queries at position 384, 512 keys); a bf16
    pool (``bits`` 16) the prefill chunk only; the heads (``kvh``, ``g``,
    ``d``).  Each is held against its plain version (``ATTN_TOL``) and
    against the dense kernel on the gathered contiguous copy (bit for bit),
    and timed beside it; returns the JSON entries."""
    import torch.nn.functional as F

    from repro_torch.cache import KernelView
    from repro_torch.kernels.decode_attention import SPLIT

    gen = torch.Generator(device=dev).manual_seed(7 + bits + page)
    k_scale, v_scale = kv_scales(torch, gen, dev, bits, kvh)
    kv_bits = 8 if bits >= 16 else bits
    # the query type of the path that reads such a pool
    qdt = torch.float32 if bits == 32 else torch.bfloat16
    dvar, dtag = head_variant(kvh, g, d)
    tag = f"paged {kv_kind(bits)} K/V, page {page}{dtag}"
    variant = {8: "@paged", 4: "@paged-int4", 16: "@paged-bf16",
               32: "@paged-f32"}[bits] + dvar
    entries = []

    def held(name, got, want, dense):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= attn_tol(bits) * (1 + want.abs().max().item()):
            raise AssertionError(f"{name} ({tag}) disagrees with its plain "
                                 f"version: max |diff| {err}")
        if not torch.equal(got, dense):
            raise AssertionError(
                f"{name} ({tag}) is not bit-identical to the dense kernel on "
                f"the gathered copy: max |diff| "
                f"{(got - dense).abs().max().item()}")
        return err

    cap = -(-(PROMPT + GEN) // 128) * 128
    if bits < 16:     # the decode kernels read quantized tiles only
        # -- decode: the scheduler's slot batch ---------------------------
        bd = SLOTS
        kp, vp, table = paged_inputs(torch, dev, gen, bd, cap, page, bits,
                                     kvh, d)
        view = KernelView(kp, vp, table, page, bits)
        kd, vd = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
        q = torch.randn((bd, kvh, g, d), generator=gen, device=dev).to(
            torch.bfloat16)
        cur = torch.tensor([0, 75, 130, 287, 401, 512, 543, cap],
                           dtype=torch.int32, device=dev)
        got = ops.decode_attention_view(q, view, k_scale, v_scale, cur)
        err = held("decode_attention", got,
                   ref.decode_attention_paged_ref(q, kp, vp, table, k_scale,
                                                  v_scale, cur, bits),
                   ops.decode_attention(q, kd, vd, k_scale, v_scale, cur,
                                        kv_bits=bits))
        ms, call = timed(torch, lambda: ops.decode_attention_view(
            q, view, k_scale, v_scale, cur))
        dense, _ = timed(torch, lambda: ops.decode_attention(
            q, kd, vd, k_scale, v_scale, cur, kv_bits=bits))
        plain, _ = timed(torch, lambda: ref.decode_attention_paged_ref(
            q, kp, vp, table, k_scale, v_scale, cur, bits))
        qh = q.reshape(bd, kvh * g, 1, d)
        kh = dequant_heads(torch, kd, k_scale, g, bits)
        vh = dequant_heads(torch, vd, v_scale, g, bits)
        mask = (torch.arange(cap, device=dev)[None, :] < cur[:, None])[
            :, None, None, :]
        lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        live = int(cur.sum())
        nbytes = (q.numel() * 2 + 2 * live * kvh * d * bits // 8 + 8 * kvh
                  + 4 * bd + 4 * sum(-(-int(c) // page) for c in cur)
                  + q.numel() * 4)
        bnd, by = bound_ms(nbytes, 4 * live * kvh * g * d, BF16_FLOPS_PER_S)
        print(f"  decode_attention [{tag}] B={bd} cache={cap} cur_pos="
              f"{cur.tolist()}: {ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)"
              f"  dense kernel on the gathered copy {dense * 1e3:.1f} us  plain "
              f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
              f"{lib * 1e3:.1f} us  max|err| {err:.2e}; bit-identical to dense")
        entries.append({
            "name": f"decode_attention[{tag}, B={bd}, ragged cur_pos, one "
                    f"layer]",
            "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:172",
            "kernel": "decode_attention" + variant, "max_abs_err": err, "ms": ms,
            "call_ms": call, "dense_ms": dense, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            "library": "SDPA on the gathered dequantized bf16, masked",
            "split": SPLIT})

    # -- the speculative verify window over the scheduler's slot batch: 5
    # queries a row at ragged q_start (windows across a page boundary, at
    # the cache's end, an inactive slot with kv_len 0) over the whole pool
    w = SPEC_K + 1
    kp, vp, table = paged_inputs(torch, dev, gen, SLOTS, cap, page, bits, kvh,
                                 d)
    view = KernelView(kp, vp, table, page, kv_bits)
    qs = torch.tensor([0, page - 2, 2 * page - 1, 300, 511, 600, cap - w,
                       77], dtype=torch.int32, device=dev)
    kl = torch.where(torch.arange(SLOTS, device=dev) == SLOTS - 1, 0, qs + w)
    q = torch.randn((SLOTS, w, kvh, g, d), generator=gen, device=dev).to(
        qdt)
    got = ops.prefill_attention_view(q, view, k_scale, v_scale, qs, kl)
    err = held("prefill_attention verify window", got,
               ref.prefill_attention_paged_ref(q, kp, vp, table, k_scale,
                                               v_scale, qs, kl,
                                               kv_bits=kv_bits),
               ops.prefill_attention(q, ref.gather_pages(kp, table),
                                     ref.gather_pages(vp, table), k_scale,
                                     v_scale, qs, kl, kv_bits=kv_bits))
    if not torch.equal(got[-1], torch.zeros_like(got[-1])):
        raise AssertionError(f"prefill_attention verify window ({tag}): the "
                             "slot with kv_len 0 is not exact zeros")
    print(f"  prefill_attention [{tag}] verify window B={SLOTS} Sq={w} "
          f"q_start={qs.tolist()}: max|err| {err:.2e}; bit-identical to "
          "dense; kv_len 0 exact zeros")

    # -- prefill: one 128-query chunk of the paged path -----------------------
    q0, limit = PROMPT - CHUNK, PROMPT
    kp, vp, table = paged_inputs(torch, dev, gen, B, cap, page, bits, kvh, d)
    table = table[:, :limit // page].contiguous()      # kernel_view(limit)
    view = KernelView(kp, vp, table, page, kv_bits)
    kd, vd = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
    q = torch.randn((B, CHUNK, kvh, g, d), generator=gen, device=dev).to(
        qdt)
    qs = torch.full((B,), q0, dtype=torch.int32, device=dev)
    kl = torch.full((B,), limit, dtype=torch.int32, device=dev)
    got = ops.prefill_attention_view(q, view, k_scale, v_scale, qs, kl)
    err = held("prefill_attention", got,
               ref.prefill_attention_paged_ref(q, kp, vp, table, k_scale,
                                               v_scale, qs, kl,
                                               kv_bits=kv_bits),
               ops.prefill_attention(q, kd, vd, k_scale, v_scale, qs, kl,
                                     kv_bits=kv_bits))
    # the same chunk at D 128, bf16 and float32 q (the wider heads run
    # their own calls)
    for dtype in ((torch.bfloat16, torch.float32) if d == 64 else ()):
        kp8, vp8, t8 = paged_inputs(torch, dev, gen, B, cap, page, bits, kvh,
                                    d=128)
        t8 = t8[:, :limit // page].contiguous()
        q8 = torch.randn((B, CHUNK, kvh, g, 128), generator=gen,
                         device=dev).to(dtype)
        e = held(f"prefill_attention D=128 q {dtype}",
                 ops.prefill_attention_view(
                     q8, KernelView(kp8, vp8, t8, page, kv_bits), k_scale,
                     v_scale, qs, kl),
                 ref.prefill_attention_paged_ref(q8, kp8, vp8, t8, k_scale,
                                                 v_scale, qs, kl,
                                                 kv_bits=kv_bits),
                 ops.prefill_attention(q8, ref.gather_pages(kp8, t8),
                                       ref.gather_pages(vp8, t8), k_scale,
                                       v_scale, qs, kl, kv_bits=kv_bits))
        print(f"  prefill_attention [{tag}] D=128 q {dtype}: max|err| "
              f"{e:.2e}; bit-identical to dense")
    ms, call = timed(torch, lambda: ops.prefill_attention_view(
        q, view, k_scale, v_scale, qs, kl))
    dense, _ = timed(torch, lambda: ops.prefill_attention(
        q, kd, vd, k_scale, v_scale, qs, kl, kv_bits=kv_bits))
    plain, _ = timed(torch, lambda: ref.prefill_attention_paged_ref(
        q, kp, vp, table, k_scale, v_scale, qs, kl, kv_bits=kv_bits),
        iters=5, warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, CHUNK, d).contiguous()
    kh = dequant_heads(torch, kd, k_scale, g, bits)
    vh = dequant_heads(torch, vd, v_scale, g, bits)
    mask = (torch.arange(limit, device=dev)[None, :]
            <= q0 + torch.arange(CHUNK, device=dev)[:, None])
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    pairs = CHUNK * q0 + CHUNK * (CHUNK + 1) // 2
    nbytes = (q.numel() * q.element_size() + 2 * B * limit * kvh * d * bits
              // 8 + 8 * kvh + 8 * B + 4 * table.numel() + q.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * d * pairs * B * kvh * g,
                       TF32_FLOPS_PER_S if bits == 32 else BF16_FLOPS_PER_S)
    print(f"  prefill_attention [{tag}] B={B} chunk of {CHUNK} at {q0}, "
          f"kv_len {limit}: {ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)"
          f"  dense kernel on the gathered copy {dense * 1e3:.1f} us  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e}; bit-identical to dense")
    entries.append({
        "name": f"prefill_attention[{tag}, B={B}, {CHUNK} queries at {q0}, "
                f"kv_len {limit}, one layer]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention" + variant, "max_abs_err": err,
        "ms": ms, "call_ms": call, "dense_ms": dense, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": lib,
        "library": "SDPA on the gathered dequantized bf16, masked"})
    return entries


def partials_close(torch, name, got, want, local):
    """One launch of the partials kernel against its plain version: acc and
    l within ``ATTN_TOL`` x (1 + max), m within ``ATTN_TOL`` x (1 + max |m|)
    where the row sees a key, and rows that see none exactly (0, -1e30, 0).
    Returns the largest error."""
    torch.cuda.synchronize()
    err = 0.0
    live = (local > 0)[:, None, None]
    for part, g, w in zip(("acc", "m", "l"), got, want):
        if part == "m":
            g, w = torch.where(live, g, 0.0), torch.where(live, w, 0.0)
        e = (g - w).abs().max().item()
        if not e <= ATTN_TOL * (1 + w.abs().max().item()):
            raise AssertionError(f"{name}: {part} differs from the plain "
                                 f"version by {e}")
        err = max(err, e)
    acc, m, l = got
    dead = ~(local > 0)
    if not (bool((acc[dead] == 0).all()) and bool((l[dead] == 0).all())
            and bool((m[dead] == -1e30).all())):
        raise AssertionError(f"{name}: a row with no visible key is not "
                             "(0, -1e30, 0)")
    return err


def check_partials(torch, ops, ref, dev, bits, kvh=3, g=3, d=64):
    """The partials kernel (B4) at the [sp path]'s decode shape: a 640-row
    cache in 4 shard views of 160 read in place, cur_pos 528 (local counts
    160, 160, 160, 48) and ragged positions with an empty row, with the
    heads (``kvh``, ``g``, ``d``); against its plain version, then the two
    invariants: one shard over the whole cache normalizes to the decode
    kernel's output bit for bit, and the merge of the 4 shards' partials
    equals the decode kernel over the whole cache.  Timed as one layer's 4
    launches; returns the JSON entry."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels.decode_attention import SPLIT
    from repro_torch.shard.partial_softmax import sp_partial_combine

    lv = 127 if bits == 8 else 7
    cap = -(-(PROMPT + GEN) // 128) * 128
    s_local = cap // SP
    cur = PROMPT + GEN // 2
    gen = torch.Generator(device=dev).manual_seed(11 + bits)
    k_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    v_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    dvar, dtag = head_variant(kvh, g, d)
    tag = ("int8" if bits == 8 else "int4 packed") + dtag

    def tiles(shape):
        t = torch.randint(-lv, lv + 1, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        return pack_int4(t) if bits == 4 else t

    kc, vc = tiles((B, cap, kvh, d)), tiles((B, cap, kvh, d))
    q = torch.randn((B, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    views = [(kc[:, i * s_local:(i + 1) * s_local],
              vc[:, i * s_local:(i + 1) * s_local]) for i in range(SP)]

    def locals_(cur_pos):
        return [torch.clamp(cur_pos - i * s_local, 0, s_local).to(
            torch.int32) for i in range(SP)]

    pos = torch.full((B,), cur, dtype=torch.int32, device=dev)
    err = merge_err = 0.0
    for cur_pos in (pos, torch.tensor([0, 75, 330, cap], dtype=torch.int32,
                                      device=dev)):
        parts = []
        for i, ((kl, vl), lp) in enumerate(zip(views, locals_(cur_pos))):
            got = ops.decode_attention_partials(q, kl, vl, k_scale, v_scale,
                                                lp, kv_bits=bits)
            want = ref.decode_attention_partials_ref(q, kl, vl, k_scale,
                                                     v_scale, lp, bits)
            err = max(err, partials_close(
                torch, f"decode_attention_partials ({tag}, shard {i})", got,
                want, lp))
            parts.append(got)
        merged = sp_partial_combine(
            [m[..., None] for _, m, _ in parts],
            [l[..., None] for _, _, l in parts],
            [a[..., None, :] for a, _, _ in parts])[:, 0]
        whole = ops.decode_attention(q, kc, vc, k_scale, v_scale, cur_pos,
                                     kv_bits=bits)
        torch.cuda.synchronize()
        e = (merged - whole).abs().max().item()
        if not e <= ATTN_TOL * (1 + whole.abs().max().item()):
            raise AssertionError(f"the merge of {SP} shards' partials "
                                 f"({tag}) differs from the decode kernel "
                                 f"over the whole cache by {e}")
        merge_err = max(merge_err, e)
    acc, _, l = ops.decode_attention_partials(q, kc, vc, k_scale, v_scale,
                                              pos, kv_bits=bits)
    norm = acc / torch.clamp_min(l, 1e-30)[..., None]
    whole = ops.decode_attention(q, kc, vc, k_scale, v_scale, pos,
                                 kv_bits=bits)
    torch.cuda.synchronize()
    if not torch.equal(norm, whole):
        raise AssertionError(
            f"one shard's partials ({tag}) do not normalize to the decode "
            f"kernel's output bit for bit: max |diff| "
            f"{(norm - whole).abs().max().item()}")
    lp = locals_(pos)

    def kernel():
        for (kl, vl), n in zip(views, lp):
            ops.decode_attention_partials(q, kl, vl, k_scale, v_scale, n,
                                          kv_bits=bits)

    def plain():
        for (kl, vl), n in zip(views, lp):
            ref.decode_attention_partials_ref(q, kl, vl, k_scale, v_scale, n,
                                              bits)

    ms, call = timed(torch, kernel)
    cold = cold_ms(torch, kernel, l2_flush(torch, dev),
                   "decode_attention_kernel")
    plain_ms, _ = timed(torch, plain)
    out_bytes = B * kvh * g * (d + 2) * 4
    nbytes = SP * (q.numel() * 2 + 8 * kvh + 4 * B + out_bytes) + \
        2 * B * cur * kvh * d * bits // 8
    bnd, by = bound_ms(nbytes, 4 * B * kvh * g * cur * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention_partials [{tag}] B={B} cache={cap} in {SP} "
          f"shard views of {s_local}, cur_pos={cur} (local "
          f"{[int(n[0]) for n in lp]}): {ms * 1e3:.1f} us warm, "
          f"{cold * 1e3:.1f} us L2-cold for the {SP} launches (per call "
          f"{call * 1e3:.1f} us)  plain {plain_ms * 1e3:.1f}"
          f" us  bound {bnd * 1e3:.2f} us  library: none  max|err| "
          f"{err:.2e}; merge vs decode kernel {merge_err:.2e}; one shard "
          f"normalized == decode kernel bit for bit")
    return {
        "name": f"decode_attention_partials[{tag} K/V, B={B}, {SP} shard "
                f"views of {s_local}, cur_pos={cur}, one layer's {SP} "
                "launches]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_partials.cu",
        "replaces": "src/repro/kernels/decode_attention.py:305",
        "kernel": "decode_attention_partials" + ("" if bits == 8 else "@int4")
                  + dvar,
        "max_abs_err": err, "merge_max_abs_err": merge_err, "ms": ms,
        "cold_ms": cold, "call_ms": call, "plain_ms": plain_ms, "bound_ms": bnd,
        "bound_by": by, "library_ms": None,
        "library": "none: no single PyTorch call returns the unnormalized "
                   "(acc, m, l)", "split": SPLIT}


def check_paged_partials(torch, ops, ref, dev, bits):
    """The partials kernel over a paged pool (the scheduler's decode shape,
    pages of 64, ragged positions incl. 0): against its plain version and
    bit for bit against the dense partials on the gathered copy; timed.
    Returns the JSON entry."""
    from repro_torch.cache import KernelView
    from repro_torch.kernels.decode_attention import SPLIT

    kvh, g, d = 3, 3, 64
    gen = torch.Generator(device=dev).manual_seed(23 + bits)
    k_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    v_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    tag = f"paged {'int8' if bits == 8 else 'int4 packed'} K/V, page {PAGE}"
    cap = -(-(PROMPT + GEN) // 128) * 128
    kp, vp, table = paged_inputs(torch, dev, gen, SLOTS, cap, PAGE, bits)
    view = KernelView(kp, vp, table, PAGE, bits)
    kd, vd = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
    q = torch.randn((SLOTS, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    cur = torch.tensor([0, 75, 130, 287, 401, 512, 543, cap],
                       dtype=torch.int32, device=dev)
    got = ops.decode_attention_partials_view(q, view, k_scale, v_scale, cur)
    err = partials_close(
        torch, f"decode_attention_partials ({tag})", got,
        ref.decode_attention_partials_paged_ref(q, kp, vp, table, k_scale,
                                                v_scale, cur, bits), cur)
    dense = ops.decode_attention_partials(q, kd, vd, k_scale, v_scale, cur,
                                          kv_bits=bits)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, dense)):
        raise AssertionError(f"decode_attention_partials ({tag}) is not "
                             "bit-identical to the dense partials on the "
                             "gathered copy")
    ms, call = timed(torch, lambda: ops.decode_attention_partials_view(
        q, view, k_scale, v_scale, cur))
    dense_ms, _ = timed(torch, lambda: ops.decode_attention_partials(
        q, kd, vd, k_scale, v_scale, cur, kv_bits=bits))
    plain, _ = timed(torch, lambda: ref.decode_attention_partials_paged_ref(
        q, kp, vp, table, k_scale, v_scale, cur, bits))
    live = int(cur.sum())
    nbytes = (q.numel() * 2 + 2 * live * kvh * d * bits // 8 + 8 * kvh
              + 4 * SLOTS + 4 * sum(-(-int(c) // PAGE) for c in cur)
              + SLOTS * kvh * g * (d + 2) * 4)
    bnd, by = bound_ms(nbytes, 4 * live * kvh * g * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention_partials [{tag}] B={SLOTS} cache={cap} "
          f"cur_pos={cur.tolist()}: {ms * 1e3:.1f} us (per call "
          f"{call * 1e3:.1f} us)  dense partials on the gathered copy "
          f"{dense_ms * 1e3:.1f} us  plain {plain * 1e3:.1f} us  bound "
          f"{bnd * 1e3:.2f} us  library: none  max|err| {err:.2e}; "
          "bit-identical to dense")
    return {
        "name": f"decode_attention_partials[{tag}, B={SLOTS}, ragged "
                "cur_pos, one layer]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_partials.cu",
        "replaces": "src/repro/kernels/decode_attention.py:305",
        "kernel": "decode_attention_partials" + (
            "@paged" if bits == 8 else "@paged-int4"),
        "max_abs_err": err, "ms": ms, "call_ms": call, "dense_ms": dense_ms,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None,
        "library": "none: no single PyTorch call returns the unnormalized "
                   "(acc, m, l)", "split": SPLIT}


def forced_logits(torch, A, engine, prompts, tokens, n):
    """Prefill + n - 1 decode steps fed with ``tokens``; the float32
    logits of each step on the CPU.  ``prompts``: (B, S) tokens, or a
    batch dict that also carries an encoder-decoder's frames or a VLM's
    patches."""
    from repro_torch.launch.engine import model_inputs

    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    with torch.inference_mode():
        inputs = model_inputs(engine.cfg, batch, engine.device)
        b, s = inputs["tokens"].shape
        cache = engine.init_cache(b, engine._cache_len(s, GEN),
                                  **engine._cache_kw(inputs))
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(engine.serve_params, inputs,
                                             cache, ctx)
        out = [logits[:, -1].float().cpu()]
        for i in range(n - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, tokens[:, i:i + 1].to(engine.device),
                cache, s + engine._prefix_len() + i, ctx)
            out.append(logits[:, -1].float().cpu())
    return out


# the port's kernels, as torch.profiler names them
PORT_KERNELS = ("quant_matmul", "prefill_attention", "decode_attention",
                "fake_quant")


def profiled(torch, fn):
    """(fn's result, torch.profiler's device rows (name, us, count), the
    profiler's count of the port's kernel launches, the wrappers' count of
    them): the profiler drops some events of graph replays now and then
    (seen on an H100), so a caller trusts the rows only when the two
    counts agree."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    def port_launches():
        # B3's int32-accumulator branch (tensor parallelism) is counted
        # apart from its other launches
        return (sum(ops.launch_counts().values())
                + ops.acc_launch_counts()["quant_matmul"])

    before = port_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    launched = port_launches() - before
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    seen = sum(c for k, _, c in rows if any(n in k for n in PORT_KERNELS))
    return out, rows, seen, launched


def breakdown(torch, engine, prompts, card, label="breakdown", walls=None,
              path="main path"):
    """Where a path's time goes: device busy time by kernel name
    (torch.profiler) against the wall clock, for prefill and for decode,
    through the engine's serving programs.  The busy times go into
    ``walls[path]`` when given; "not measured" when the profiler records
    no device time or misses a launch of the port's kernels."""
    def busy(gen):
        return profiled(torch, lambda: engine.generate_batch(
            {"tokens": prompts}, gen=gen))

    steps = 8
    # the programs of this shape are captured here if they were not yet,
    # outside the profiled calls
    engine.generate_batch({"tokens": prompts}, gen=1 + steps)
    res1, pre, seen1, n1 = busy(1)
    res2, both, seen2, n2 = busy(1 + steps)
    pre_us = sum(t for _, t, _ in pre)
    dec = {k: [t, c] for k, t, c in both}
    for k, t, c in pre:
        d = dec.setdefault(k, [0, 0])
        d[0] -= t
        d[1] -= c
    dec_us = sum(t for t, _ in dec.values()) / steps
    if pre_us == 0 or (seen1, seen2) != (n1, n2):
        print(f"[{label}] the profiler recorded {seen1} + {seen2} of the "
              f"{n1} + {n2} launches of the port's kernels: device busy not "
              "measured")
        return
    driver = ("graphs" if engine.eager_reason() is None
              else "eager, sp > 1")
    print(f"[{label}] ({driver}) prefill: device busy {pre_us / 1e3:.2f} ms "
          f"of {res1.prefill_s * 1e3:.2f} ms wall (profiled); decode: device "
          f"busy {dec_us / 1e3:.3f} ms of {res2.decode_s / steps * 1e3:.2f} "
          f"ms wall per step (profiled) on {card}")
    if walls is not None:
        walls.setdefault(path, {})["busy"] = (pre_us / 1e3, dec_us / 1e3)
    for title, rows, div in (("prefill", [(k, t) for k, t, _ in pre], 1),
                             ("decode step", [(k, v[0]) for k, v in
                                              dec.items()], steps)):
        top = sorted(rows, key=lambda r: -r[1])[:6]
        print(f"  top device time per {title}: " + "; ".join(
            f"{k[:48]} {t / div / 1e3:.3f} ms" for k, t in top))
    attn = [(t, c) for k, (t, c) in dec.items()
            if "decode_attention_kernel" in k]
    print(f"  decode attention kernel (B1/B4) per decode step: "
          f"{sum(t for t, _ in attn) / steps / 1e3:.3f} ms in "
          f"{sum(c for _, c in attn) / steps:.0f} launches")


def program_busy(torch, prog, n=3):
    """Device busy per call of a captured program (torch.profiler over
    ``n`` replays), or None when the profiler records no device time or
    misses a launch of the port's kernels."""
    def replays():
        with torch.inference_mode():
            for _ in range(n):
                prog()

    _, rows, seen, launched = profiled(torch, replays)
    us = sum(t for _, t, _ in rows)
    return us / n / 1e3 if us > 0 and seen == launched else None


def path_layers(cfg):
    """(attention layers, global attention layers, quant_matmul launches a
    token) of a config's serving path: an attention layer runs 4 and its
    ffn 3 (3 a expert with MoE, none in mamba2), a Mamba2 mixer 6, an
    untied lm_head 1."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    attn = [i for i, k in enumerate(kinds) if k != "mamba"]
    ffn = {"moe": 3 * cfg.n_experts, "none": 0}.get(cfg.ffn, 3)
    per_token = sum(4 * (k != "mamba") + 6 * (k in ("mamba", "hybrid"))
                    + ffn for k in kinds) + (not cfg.tie_embeddings)
    return (len(attn), sum(cfg.attn_window(i) is None for i in attn),
            per_token)


def drive_main_path(torch, ops, engine, prompts, label, kind, card,
                    sp=1, walls=None, A=None, strict=False):
    """Warm up, zero the launch counts, serve 4 x 512 prompts for 32 tokens
    and check what came out and which kernels ran; returns (result, all
    launch counts, int4-variant, bf16-K/V, paged, windowed and float32
    launch counts; the float32 ones with the run's int4-weight B3 launches
    under "quant_matmul_w4"), each read from the timed run of the captured
    programs and checked for both drivers.
    The default ``generate_batch`` replays its captured programs: the
    warm-up call captures them (its ``compile_s``), the timed call must
    only replay, and the eager ``loop=True`` driver, run after it with the
    same launch counts, must give its tokens and prefill logits bit for bit
    (``compare_programs``); both walls go into ``walls[label]``.
    ``sp`` > 1: a sequence-parallel engine, which serves through the eager
    driver (ROADMAP item 9d), whose one-shot prefill attends without a
    kernel and whose decode launches the partials kernel once per shard
    and layer instead of the decode kernel.  bf16 weights (mode "none")
    launch no quant_matmul; a bf16 KV cache runs prefill attention through
    B2's bf16 branch and decodes in plain attention, no B1.  A windowed
    layer (gemma3-12b's local ones) prefills through B2 with its window
    and decodes in plain attention, as the reference does: B1 runs on the
    global layers only; an untied lm_head is one more quant_matmul a
    token; an MoE layer launches quant_matmul 4 times for attention and 3
    times for each of its experts, a pass; a Mamba2 mixer 6 times, and
    attention kernels only where a layer has attention (``path_layers``).
    A float32 config prefills a float cache through B2's float32 branch
    (not its bf16 one), and its expert products run B3's float32 output.
    ``prompts`` may have other rows and lengths than B x PROMPT.
    ``strict``: graphs and eager must agree bit for bit, with no near-tie
    allowed (``compare_programs``)."""
    warm = engine.generate_batch({"tokens": prompts}, gen=2)   # warm-up
    cfg = engine.cfg
    b, s = prompts.shape
    n_layers, n_global, per_token = path_layers(cfg)
    kv8 = engine.policy.kv_int8
    expected = {"quant_matmul":
                    per_token * GEN if engine.mode == "int8" else 0,
                "prefill_attention": n_layers if sp == 1 else 0,
                "decode_attention":
                    n_global * (GEN - 1) if sp == 1 and kv8 else 0,
                "decode_attention_partials":
                    n_global * (GEN - 1) * sp if sp > 1 and kv8 else 0,
                "fake_quant": 0}
    int4_expected = ({k: expected[k] for k in ops.ATTENTION}
                     if kv8 and engine.policy.kv_bits == 4
                     else {k: 0 for k in ops.ATTENTION})
    f32 = cfg.dtype == torch.float32
    bf16_expected = {"prefill_attention":
                     0 if kv8 or f32 else expected["prefill_attention"]}
    experts = (3 * cfg.n_experts * n_layers * GEN
               if cfg.ffn == "moe" and engine.mode == "int8" else 0)
    f32_expected = {"quant_matmul": experts if f32 else 0,
                    "prefill_attention": expected["prefill_attention"]
                    if f32 and not kv8 else 0}
    # the engine's caches are dense or rings: no paged launch
    paged_expected = {k: 0 for k in ops.ATTENTION}
    window_expected = {"prefill_attention":
                       n_layers - n_global if sp == 1 else 0}

    def run(loop):
        ops.reset_launches()
        res = engine.generate_batch({"tokens": prompts}, gen=GEN, loop=loop)
        got = (ops.launch_counts(), ops.int4_launch_counts(),
               ops.bf16_launch_counts(), ops.paged_launch_counts(),
               ops.window_launch_counts(), ops.f32_launch_counts())
        want = (expected, int4_expected, bf16_expected, paged_expected,
                window_expected, f32_expected)
        driver = "loop=True" if loop else "default"
        print(f"[{label}] ({driver}) kernel launches {got[0]} (expected "
              f"{expected}); int4 variants {got[1]} (expected "
              f"{int4_expected}); bf16 K/V variants {got[2]} (expected "
              f"{bf16_expected}); paged variants {got[3]}; windowed "
              f"{got[4]} (expected {window_expected}); float32 variants "
              f"{got[5]} (expected {f32_expected})")
        if got != want:
            raise AssertionError(f"{driver}: launch counts {got} != {want}")
        # the float32 counts also carry this run's int4-weight B3 launches
        # (the smaller of the two bounds B3's int4 float32-output launches)
        return (res, *got[:5], {**got[5], "quant_matmul_w4":
                                ops.w4_launch_counts()["quant_matmul"]})

    res, counts, int4, bf16, paged, window, f32_counts = run(False)
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (b, GEN) or not bool(
            ((toks >= 0) & (toks < engine.cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    prefill_tps = b * s / res.prefill_s
    decode_ms = res.decode_s / (GEN - 1) * 1e3
    graphs = engine.eager_reason() is None
    print(f"[{label}] prefill {b}x{s} tokens: {res.prefill_s * 1e3:.1f}"
          f" ms = {prefill_tps:.0f} tokens/s; decode: {decode_ms:.2f} ms per "
          f"step of {b} tokens (ms/token per request) on {kind} ({card}); "
          + (f"graphs captured in {warm.compile_s:.3f} s before the timed "
             f"windows (compile_s of the first call; the timed call "
             f"{res.compile_s:.1f})" if graphs else
             f"no graphs: {engine.eager_reason()}"))
    if graphs and (warm.compile_s <= 0.0 or res.compile_s != 0.0):
        raise AssertionError(f"compile_s {warm.compile_s} then "
                             f"{res.compile_s}: the first call must capture, "
                             "the second only replay")
    if graphs:
        eager = run(True)[0]
        compare_programs(torch, A, engine, prompts, res, eager, label,
                         strict)
        print(f"[{label}] walls, graphs vs eager loop=True: prefill "
              f"{res.prefill_s * 1e3:.2f} vs {eager.prefill_s * 1e3:.2f} ms;"
              f" decode {decode_ms:.3f} vs "
              f"{eager.decode_s / (GEN - 1) * 1e3:.3f} ms per step; "
              f"compile_s {warm.compile_s:.3f} vs {eager.compile_s:.1f} s")
        if walls is not None:
            walls.setdefault(label, {}).update(
                graphs=(res.prefill_s * 1e3, decode_ms, warm.compile_s),
                eager=(eager.prefill_s * 1e3,
                       eager.decode_s / (GEN - 1) * 1e3))
    return res, counts, int4, bf16, paged, window, f32_counts


def forced_gap(torch, A, engine, prompts, toks):
    """The largest logit gap, over every step and row, between the argmax
    of the eager steps teacher-forced on ``toks`` and ``toks``' own
    token."""
    lgs = forced_logits(torch, A, engine, torch.as_tensor(prompts),
                        toks.cpu(), toks.shape[1])
    return max((lg.max(-1).values - lg.gather(
        1, toks[:, i:i + 1].cpu())[:, 0]).max().item()
        for i, lg in enumerate(lgs))


def cublas_capture_probe(torch, engine):
    """The path's cuBLAS products (the bf16 readout; with bf16 weights the
    layer products; over a bf16 cache the plain decode attention), each at
    its decode shape: {name: bits equal} between an eager call and a
    captured graph's replay on the same inputs."""
    from repro_torch.models.attention import decode_attention

    dev, cfg = engine.device, engine.cfg
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, cfg.dtype)

    table = engine.serve_params["embed"]["table"]
    cases = {"readout x @ table.T": (lambda x: x @ table.T,
                                     (rand(B, cfg.d_model),))}
    if engine.mode == "none":
        layer = engine.serve_params["stack"]["layer0"]
        for name, w in (("wq", layer["attn"]["wq"]["w"]),
                        ("gate", layer["ffn"]["gate"]["w"]),
                        ("down", layer["ffn"]["down"]["w"])):
            cases[f"bf16 weights x @ {name}"] = (
                lambda x, w=w: x @ w, (rand(B, w.shape[0]),))
    if not engine.policy.kv_int8:
        cap, g = engine._cache_len(PROMPT, GEN), cfg.n_heads // cfg.n_kv_heads
        valid = torch.full((B,), PROMPT + 1, dtype=torch.int32, device=dev)
        cases["plain decode attention (einsum)"] = (
            lambda q, k, v: decode_attention(q, k, v, valid),
            (rand(B, 1, cfg.n_kv_heads, g, cfg.head_dim),
             rand(B, cap, cfg.n_kv_heads, cfg.head_dim),
             rand(B, cap, cfg.n_kv_heads, cfg.head_dim)))
    same = {}
    with torch.inference_mode():
        for name, (fn, args) in cases.items():
            want = fn(*args)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*args)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = fn(*args)
            graph.replay()
            torch.cuda.synchronize()
            same[name] = torch.equal(got, want)
    return same


def compare_programs(torch, A, engine, prompts, res, eager, label,
                     strict=False):
    """The captured programs' tokens and prefill logits against the eager
    driver's: bit for bit.  Where they differ, the cuBLAS products of the
    path are probed eager against captured (``cublas_capture_probe``); a
    difference is accepted only where a probed product gives other bits
    under capture and the eager steps, teacher-forced on the graphs'
    tokens, put every one of them within ``LOGIT_ATOL`` of their argmax
    (the near-tie rule of PERF.md §2), and never with ``strict``."""
    if (torch.equal(res.prefill_logits, eager.prefill_logits)
            and torch.equal(res.tokens, eager.tokens)):
        print(f"[{label}] graphs vs eager loop=True: prefill logits and "
              f"{GEN} greedy tokens bit-identical")
        return
    diff = (res.prefill_logits.float() - eager.prefill_logits.float()).abs()
    same_toks = int((res.tokens == eager.tokens).sum())
    probe = cublas_capture_probe(torch, engine)
    gap = forced_gap(torch, A, engine, prompts, res.tokens)
    print(f"[{label}] graphs vs eager loop=True DIFFER: prefill logits max "
          f"|diff| {diff.max().item():.6f}, tokens equal {same_toks}/"
          f"{res.tokens.numel()}; cuBLAS products bit-equal under capture: "
          f"{probe}; the eager steps teacher-forced on the graphs' tokens put"
          f" them at most {gap:.4f} below their argmax (near-tie tolerance "
          f"{LOGIT_ATOL})")
    if strict or all(probe.values()) or not gap <= LOGIT_ATOL:
        raise AssertionError(f"graphs and eager driver disagree (probe "
                             f"{probe}, gap {gap})")


def profile_graph_replay(torch, engine, card, attempts=3):
    """Whether torch.profiler sees the kernels of a graph replay: three
    replays of the engine's captured decode step, profiled, and the
    port's kernels it saw against those the replays launched (up to
    ``attempts`` tries: it drops events now and then)."""
    prog = engine._program
    with torch.inference_mode():
        prog.decode()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        def replays():
            with torch.inference_mode():
                for _ in range(3):
                    prog.decode()

        _, rows, seen, launched = profiled(torch, replays)
        if not rows:
            print(f"[graphs] torch.profiler records NO device time in a "
                  f"CUDA graph replay on {card}: graph-path device busy is "
                  "not measured")
            return False
        total = sum(t for _, t, _ in rows) / 3 / 1e3
        ours = {k[:40]: c // 3 for k, _, c in rows
                if any(n in k for n in PORT_KERNELS)}
        print(f"[graphs] torch.profiler sees the kernels of a graph replay "
              f"on {card} (try {attempt}): {total:.3f} ms device busy per "
              f"replayed decode step, {sum(c for _, _, c in rows) // 3} "
              f"kernels; the port's per step {ours}, {seen} of the {launched}"
              " launched")
        if seen == launched:
            return True
    print(f"[graphs] the profiler missed kernels of a replay in all "
          f"{attempts} tries: breakdowns that miss any are not measured")
    return False


def print_walls(walls, card):
    """The [graphs] table: per path, graphs against the eager driver
    (prefill ms, decode ms per step, compile_s) beside the device busy of
    the graph replays."""
    def fmt(v, n=2):
        return "not measured" if v is None else f"{v:.{n}f}"

    print(f"[graphs] walls per path on {card}: graphs prefill ms / decode ms "
          "per step / compile s | eager loop=True prefill / decode | device "
          "busy prefill / decode (graphs, profiled)")
    for label, w in walls.items():
        g = w.get("graphs", (None, None, None))
        e = w.get("eager", (None, None))
        b = w.get("busy", (None, None))
        print(f"  {label}: {fmt(g[0])} / {fmt(g[1], 3)} / {fmt(g[2], 3)} | "
              f"{fmt(e[0])} / {fmt(e[1], 3)} | {fmt(b[0])} / {fmt(b[1], 3)}")


def cpu_check(torch, A, engine, prompts, toks, tol, label, n_check=4,
              logit_tol=None, plain_ops=None, held=None, forced=None):
    """Teacher-forced logits of the GPU engine against the same engine
    moved to the CPU (plain versions), over ``n_check`` steps: the GPU's
    token must be the CPU's argmax or within ``tol`` of it (a near-tie that
    rounding may flip), and no logit may differ by more than ``logit_tol``
    (``tol`` when not given).  With ``plain_ops`` (the ``kernels.ops``
    module) the twin is the same engine on the card with every kernel's
    plain version instead.  ``held``, called once both devices have run,
    returns an (n_check, B) bool mask: only the (step, request) pairs it
    marks are held to ``tol`` and ``logit_tol`` (the MoE copies: a request
    up to its first routing flip), and at least half must be.  ``forced``:
    the two devices' logits of the same steps, already run (``stage_gaps``
    returns them), in place of running them again."""
    logit_tol = tol if logit_tol is None else logit_tol
    tok_t = torch.as_tensor(toks, dtype=torch.long)
    if not isinstance(prompts, dict):
        prompts = torch.as_tensor(prompts)
    gpu = (forced_logits(torch, A, engine, prompts, tok_t, n_check)
           if forced is None else forced[0])
    for i, lg in enumerate(gpu):
        if not torch.equal(lg.argmax(-1), tok_t[:, i]):
            raise AssertionError(f"step {i}: teacher-forced GPU argmax "
                                 f"differs from generate_batch's tokens")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: non-finite logits")
    t0 = time.perf_counter()
    if forced is not None:
        twin, cpu = "the CPU (plain versions; the stage trace's run)", forced[1]
    elif plain_ops is None:
        twin = "the CPU (plain versions)"
        cpu = forced_logits(torch, A, engine.to("cpu"), prompts, tok_t,
                            n_check)
    else:
        twin = "the card with the plain versions"
        with plain_ops.plain_versions():
            cpu = forced_logits(torch, A, engine, prompts, tok_t, n_check)
    n_rows = tok_t.shape[0]
    mask = (torch.ones((n_check, n_rows), dtype=torch.bool) if held is None
            else held())
    worst, same, ties, gaps, steps = 0.0, 0, 0, [], []
    for i, (g_lg, c_lg) in enumerate(zip(gpu, cpu)):
        rows = mask[i].nonzero()[:, 0]
        steps.append((g_lg[rows] - c_lg[rows]).abs().max().item()
                     if len(rows) else 0.0)
        worst = max(worst, steps[-1])
        pick = c_lg.argmax(-1)
        for r in rows.tolist():
            gap = (c_lg[r, pick[r]] - c_lg[r, tok_t[r, i]]).item()
            if int(pick[r]) == int(tok_t[r, i]):
                same += 1
            elif gap <= tol:
                ties += 1   # a near-tie that bf16 rounding may flip
            else:
                gaps.append(f"step {i} row {r}: CPU picks {int(pick[r])}, "
                            f"GPU {int(tok_t[r, i])}, {gap:.4f} apart")
    # the logits' own size, over the real vocabulary (the padded entries
    # read -1e9 on both devices)
    real = torch.cat([lg[:, :engine.cfg.vocab] for lg in cpu]).abs()
    n_held = int(mask.sum())
    print(f"[{label}] {n_check} teacher-forced steps on {twin} "
          f"in {time.perf_counter() - t0:.1f} s: max |logit diff| "
          f"{worst:.4g} (tolerance {logit_tol}; by step "
          f"{', '.join(f'{e:.4g}' for e in steps)}; max |logit| "
          f"{real.max().item():.3f}, median "
          f"{real.median().item():.3f}); greedy tokens equal "
          f"{same}/{n_held}, near-ties {ties}, further apart {len(gaps)}"
          + ("" if held is None else
             f"; held to the limits: {n_held} of {mask.numel()} "
             "(request, step) pairs"))
    if gaps:
        raise AssertionError(f"tokens differ by more than {tol}: {gaps}")
    if worst > logit_tol:
        raise AssertionError(f"GPU and CPU logits differ by {worst}")
    if 2 * n_held < mask.numel():
        raise AssertionError(f"only {n_held} of {mask.numel()} (request, "
                             "step) pairs held to the limits")


def int8_bytes(torch, tree) -> int:
    """Bytes of the int8 tensors of a param tree: the resident int8
    weights."""
    if isinstance(tree, dict):
        return sum(int8_bytes(torch, v) for v in tree.values())
    return tree.numel() if tree.dtype == torch.int8 else 0


def wide_engine(torch, Engine, build_model, cfg, seed=0, **kw):
    """The int8 engine of ``cfg`` (``Engine.from_checkpoint``: calibration,
    int8 conversion) over seeded random weights drawn on the card by a CUDA
    ``torch.Generator`` (the engine's default draw runs on the CPU in
    float32: 30-50 GB of host memory and minutes of one-stream ``randn`` at
    8-12 B parameters); returns (engine, seconds)."""
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed))
    engine = Engine.from_checkpoint(cfg=cfg, params=params, **kw)
    del params
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def drive_arch_path(torch, ops, A, Engine, build_model, cfg, label, kind,
                    card, walls):
    """One wider config at full width (``cfg``'s depth) through the int8
    main path: its engine (weights drawn on the card), then
    ``drive_main_path`` on 4 x 512 prompts for 32 tokens (graphs == eager
    bit for bit, every kernel of the path launched as counted) and
    ``replay_busy``; prints the build time, the resident int8 weight bytes
    and the peak device
    memory.  Returns (engine, ``drive_main_path``'s launch counts: all,
    int4, bf16, paged, windowed)."""
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    engine, build_s = wide_engine(torch, Engine, build_model, cfg)
    w8 = int8_bytes(torch, engine.serve_params)
    print(f"[{label}] {cfg.name} full width: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k} (capacity factor "
             f"{cfg.capacity_factor})" if cfg.ffn == "moe" else "")
          + (f", kind {cfg.kind}: Mamba2 d_inner "
             f"{cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, head "
             f"dim {cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}"
             if cfg.kind in ("mamba", "hybrid") else "")
          + f"{'' if cfg.tie_embeddings else ' (untied lm_head)'}, norm "
          f"{cfg.norm}, mlp {cfg.mlp_activation}, windows "
          f"{sorted({str(cfg.attn_window(i)) for i in range(cfg.n_layers)})}"
          f": weights drawn on the card, calibration and int8 conversion in "
          f"{build_s:.1f} s; {engine.n_int8_weights()} int8 weight tensors, "
          f"{w8 / 1e9:.3f} GB int8 resident; peak device memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(sum(map(ord, cfg.name)))
    prompts = rng.integers(0, cfg.vocab, (B, PROMPT), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    counts = drive_main_path(torch, ops, engine, prompts, label, kind, card,
                             walls=walls, A=A)[1:6]
    print(f"[{label}] peak device memory serving {B}x{PROMPT} + {GEN}: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, weights included)")
    replay_busy(torch, engine, label, walls)
    return engine, counts


def replay_busy(torch, engine, label, walls):
    """Device busy of the engine's captured prefill and of one decode
    step, each program's replays profiled alone, with the kernels that
    take the most of it: at 8-12 B parameters the profiler loses a few of
    a replay's ~300-3,000 launches now and then (``breakdown``'s
    difference of two profiled calls is then not measured, and retries
    seldom help).  A profile that sees every launch of the port's kernels
    gives the busy time; else its sum is printed as a lower bound, with
    the launches it saw.  Exact values go into ``walls[label]["busy"]``."""
    prog = engine._program
    got = []
    for name, fn, n in (("prefill", prog.prefill, 3),
                        ("decode step", prog.decode, 8)):
        def replays(fn=fn, n=n):
            with torch.inference_mode():
                for _ in range(n):
                    fn()

        _, rows, seen, launched = profiled(torch, replays)
        ms = sum(t for _, t, _ in rows) / n / 1e3
        got.append(ms if seen == launched and ms > 0 else None)
        print(f"[{label} busy] {name} replays profiled alone: "
              + (f"{ms:.3f} ms busy" if seen == launched else
                 f">= {ms:.3f} ms busy (a lower bound: the profiler saw "
                 f"{seen} of the {launched} launches of the port's kernels)"))
        top = sorted(rows, key=lambda r: -r[1])[:6]
        print(f"  top device time per {name}: " + "; ".join(
            f"{k[:48]} {t / n / 1e3:.3f} ms" for k, t, _ in top))
    walls.setdefault(label, {})["busy"] = tuple(got)


def drive_ring_path(torch, ops, A, Engine, engine, label, kind, card, walls,
                    b=RING_B, s=RING_PROMPT, window=WINDOW):
    """A windowed config with its rings: ``b`` prompts of ``s`` tokens and
    32 generated tokens in the engine's default "ring" layout, where each
    windowed layer holds a ring of ``window`` slots and each global layer a
    dense cache (gemma3-12b: 40 rings of 1024 beside 8 dense layers, 2 x
    2048; mixtral-8x7b: a ring of 4096 on every layer, 2 x 4608, so the
    window slides during the prefill and every decode step): prefill
    through B2 with the window, ring decode on the windowed layers, B1 on
    the global ones, through the captured programs and bit for bit the
    eager driver; the tokens against the same engine with dense caches,
    teacher-forced (equal, or within ``LOGIT_ATOL`` of its argmax).
    Returns ``drive_main_path``'s launch counts (all, int4, bf16, paged,
    windowed)."""
    cfg = engine.cfg
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    cache_len = engine._cache_len(s, GEN)
    caches = engine.init_cache(b, cache_len)
    layouts = [(c["attn"].layout, c["attn"].capacity)
               for c in caches.values()]
    del caches
    n_local = sum(cfg.attn_window(i) is not None
                  for i in range(cfg.n_layers))
    if engine.cache_layout != "ring" or layouts.count(
            ("ring", window)) != n_local or layouts.count(
            ("dense", cache_len)) != cfg.n_layers - n_local:
        raise AssertionError(f"{cfg.name}'s caches at {cache_len}: "
                             f"{sorted(set(layouts))}")
    print(f"[{label}] caches: {n_local} rings of {window} slots, "
          f"{cfg.n_layers - n_local} dense of {cache_len} positions")
    torch.cuda.reset_peak_memory_stats()
    res, *counts, _ = drive_main_path(torch, ops, engine, prompts, label,
                                      kind, card, walls=walls, A=A)
    print(f"[{label}] peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    replay_busy(torch, engine, label, walls)
    dense = Engine(engine.model, cfg, engine.policy, engine.serve_params,
                   engine.qparams, device=engine.device, cache_layout="dense")
    dres = dense.generate_batch({"tokens": prompts}, gen=GEN)
    same = int((dres.tokens == res.tokens).sum())
    gap = forced_gap(torch, A, dense, prompts, res.tokens)
    print(f"[{label}] ring tokens vs the dense caches' (graphs): equal "
          f"{same}/{res.tokens.numel()}; the dense engine teacher-forced on "
          f"the ring's tokens puts them at most {gap:.4f} below its argmax "
          f"(near-tie tolerance {LOGIT_ATOL}); dense walls: prefill "
          f"{dres.prefill_s * 1e3:.2f} ms, decode "
          f"{dres.decode_s / (GEN - 1) * 1e3:.3f} ms per step")
    del dense, dres
    if not gap <= LOGIT_ATOL:
        raise AssertionError(f"ring and dense caches disagree by {gap}")
    return counts


# the depth-cut copies of [<arch> cpu check]: a 64-token prompt passes
# the window of a copy with local layers
CPU_WINDOW = 32


def routing_flips(records, n_tokens, s, n_moe):
    """(token choices, those whose expert set differs between two runs of
    the same teacher-forced steps, the largest probability gap at such a
    choice, each request's first position with a flipped choice) from a
    ``moe.routing_log``'s records of the two runs one after the other (the
    card's, then the CPU's or the card's with the plain versions): a
    prefill over positions 0..s-1, then one decode call a position, each
    call one record per MoE layer (``n_moe``); each run must have routed
    ``n_tokens`` (layers x requests x positions)."""
    half = len(records) // 2
    runs = {"first": [(idx, gap) for _, idx, gap in records[:half]],
            "second": [(idx, gap) for _, idx, gap in records[half:]]}
    for run, recs in runs.items():
        got = sum(idx.shape[0] * idx.shape[1] for idx, _ in recs)
        if got != n_tokens:
            raise AssertionError(f"routing log: the {run} run routed {got} "
                                 f"token choices, expected {n_tokens}")
    total, flipped, worst, first = 0, 0, 0.0, {}
    for k, ((a, gap), (b, _)) in enumerate(zip(runs["first"],
                                               runs["second"])):
        if a.shape != b.shape:
            raise AssertionError(f"routing log: the runs' dispatches "
                                 f"pair {tuple(a.shape)} with "
                                 f"{tuple(b.shape)}")
        diff = (a != b).any(-1)                 # (requests, positions)
        total += diff.numel()
        flipped += int(diff.sum())
        if diff.any():
            worst = max(worst, float(gap[diff].max()))
        call = k // n_moe
        pos0 = 0 if call == 0 else s + call - 1
        for r, t in diff.nonzero().tolist():
            first[r] = min(first.get(r, pos0 + t), pos0 + t)
    return total, flipped, worst, first


def readout_qparams(cfg, qparams):
    """``qparams`` with an untied lm_head's activation thresholds taken
    from the last block's ``wq`` (both read a norm's output); a tied
    readout's come back as they are."""
    if cfg.tie_embeddings:
        return qparams
    head = f"{cfg.name}/lm_head"
    last = f"{cfg.name}/stack/layer{cfg.n_layers - 1}/attn/wq"
    return {**qparams, head: {**qparams[head], "act": qparams[last]["act"]}}


def readout_thresholds(Engine, engine, label):
    """The engine with an untied lm_head served on the last block's ``wq``
    activation thresholds (``readout_qparams``): calibration, as the
    reference's, never observes the readout's input and leaves its
    threshold at the 1e-8 floor, where every logit is ~1e-8 and a check of
    the logits would hold for any readout.  A tied readout's engine comes
    back as it is."""
    cfg = engine.cfg
    if cfg.tie_embeddings:
        return engine
    floor = engine.qparams[f"{cfg.name}/lm_head"]["act"]["t_max"].item()
    print(f"[{label}] the untied lm_head's calibrated activation threshold "
          f"is {floor:.1e} (the floor); served here with the last block's "
          "wq thresholds")
    return Engine(engine.model, cfg, engine.policy, engine.serve_params,
                  readout_qparams(cfg, engine.qparams), device=engine.device,
                  mode=engine.mode)


def check_arch_cpu(torch, ops, A, Engine, build_model, cfg, label,
                   logit_tol=None):
    """A full-width copy of a wider config at cut depth (weights drawn on
    the card): 2 layers, or one local:global period (gemma3-12b: 5 local
    layers, then a global one) with the window cut to ``CPU_WINDOW``, so
    that a 64-token prompt passes it: B2's window mask, the rings and B1 on
    the global layer all run (mixtral-8x7b, windowed everywhere: 2 layers,
    both rings).  An MoE copy also counts the tokens that the two devices'
    routers send to other experts (a near-tie of the router's float32
    product: ``moe.routing_log``).  1 prompt, 8 generated tokens (every kernel
    launched as counted), held against the same engine on the CPU
    (``cpu_check``, 8 teacher-forced steps, ``CPU_CHECK_STEPS`` where
    fewer; tokens within ``LOGIT_ATOL``,
    logits within ``WIDE_LOGIT_ATOL``).  An untied readout (stablelm-
    12b) serves the last block's ``wq`` thresholds here: calibration, as
    the reference's, never observes its input and leaves its threshold at
    the 1e-8 floor, where every logit is ~1e-8 and the check would hold
    for any readout.  ``logit_tol``: the logits' limit in place of
    ``WIDE_LOGIT_ATOL``'s."""
    free_card(torch)
    logit_tol = logit_tol or WIDE_LOGIT_ATOL[cfg.name]
    over = dict(n_layers=2)
    if cfg.local_global_ratio:
        over = dict(n_layers=sum(cfg.local_global_ratio), window=CPU_WINDOW)
    elif cfg.window_all:
        over = dict(n_layers=2, window=CPU_WINDOW)
    elif cfg.kind == "hybrid":
        over = dict(n_layers=2, window=CPU_WINDOW, global_attn_layers=(0,))
    cut = cfg.replace(**over)
    engine, build_s = wide_engine(torch, Engine, build_model, cut, seed=1)
    engine = readout_thresholds(Engine, engine, label)
    gen = 8
    b, s = MOE_CPU_REQUESTS.get(cfg.name, 1), MOE_CPU_PROMPT.get(cfg.name, 64)
    n_check = CPU_CHECK_STEPS.get(cfg.name, gen)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab, (b, s),
                                                 dtype=np.int32)
    n_attn, n_global, _ = path_layers(cut)
    n_local = n_attn - n_global
    layouts = [c["attn"].layout for c in engine.init_cache(
        b, engine._cache_len(s, gen)).values() if "attn" in c]
    if layouts.count("ring") != n_local:
        raise AssertionError(f"{n_local} windowed layers, caches {layouts}")
    engine.generate_batch({"tokens": prompts}, gen=gen)   # captures
    ops.reset_launches()
    res = engine.generate_batch({"tokens": prompts}, gen=gen)
    got = (ops.launch_counts()["decode_attention"],
           ops.window_launch_counts()["prefill_attention"])
    want = (n_global * (gen - 1), n_local)
    print(f"[{label}] {cfg.name} at full width, {over} (built in "
          f"{build_s:.1f} s): {b} x {s} prompts, {gen} tokens "
          f"{res.tokens.tolist()}; caches {layouts}; decode_attention and "
          f"windowed prefill_attention launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    if cut.ffn != "moe":
        cpu_check(torch, A, engine, prompts, res.tokens.cpu(), LOGIT_ATOL,
                  label, n_check=n_check, logit_tol=logit_tol)
        return
    with moe_held(label, cut, b, s, n_check) as held:
        try:
            cpu_check(torch, A, engine, prompts, res.tokens.cpu(),
                      LOGIT_ATOL, label, n_check=n_check,
                      logit_tol=logit_tol, held=held)
        finally:
            if held.unflipped and not cut.window_all:
                stage_gaps(torch, A, engine, prompts, res.tokens.cpu(),
                           n_check, label, rows=held.unflipped)


class moe_held:
    """A ``moe.routing_log`` around an MoE engine's ``cpu_check`` of ``b``
    requests of ``s`` tokens over ``n_check`` teacher-forced steps; called
    (as ``cpu_check``'s ``held``) it counts the routing choices that the
    card and its twin (``twin``: the CPU, or the card's plain versions)
    make otherwise, fails unless each is a near-tie (a probability gap of
    at most ``ROUTER_NEAR_TIE``), prints the three counts (flipped
    choices, requests cut at a flip, pairs held) and returns the
    (n_check, b) mask of the pairs before each request's first flip: step
    i reads positions up to s - 1 + i.  ``unflipped`` then lists the
    requests with no flip."""

    def __init__(self, label, cfg, b, s, n_check, twin="CPU"):
        self.label, self.cfg, self.twin = label, cfg, twin
        self.b, self.s, self.n_check = b, s, n_check
        self.unflipped = None

    def __enter__(self):
        from repro_torch.models import moe

        self._log = moe.routing_log()
        self.records = self._log.__enter__()
        return self

    def __exit__(self, *exc):
        self._log.__exit__(*exc)

    def __call__(self):
        import torch

        n_moe = sum(self.cfg.layer_kind(i) != "mamba"
                    for i in range(self.cfg.n_layers))
        total, flipped, worst, first = routing_flips(
            self.records, n_moe * self.b * (self.s + self.n_check - 1),
            self.s, n_moe)
        steps = torch.arange(self.n_check)[:, None] + self.s - 1
        cut = torch.tensor([first.get(r, self.s + self.n_check)
                            for r in range(self.b)])
        mask = steps < cut[None, :]
        self.unflipped = [r for r in range(self.b) if r not in first]
        print(f"[{self.label}] routing, card vs {self.twin} over the "
              f"{self.n_check} "
              f"teacher-forced steps of {self.b} x {self.s} prompts: "
              f"{flipped} of {total} token choices (layer x token) sent to "
              f"other experts"
              + (f", at probability gaps up to {worst:.2e} (near-tie limit "
                 f"{ROUTER_NEAR_TIE})" if flipped else "")
              + f"; {len(first)} of {self.b} requests cut at their first "
              f"flip (positions {sorted(first.values())}); "
              f"{int(mask.sum())} of {mask.numel()} (request, step) pairs "
              "held to the limits")
        if worst > ROUTER_NEAR_TIE:
            raise AssertionError(f"a routing choice flipped at a probability "
                                 f"gap of {worst} > {ROUTER_NEAR_TIE}")
        return mask


def media_batch(cfg, b, s_text, s_frames, seed):
    """``b`` requests of ``s_text`` tokens and the frontend's input,
    standard normal float32: ``s_frames`` frames (B, S, frame_dim) of an
    encoder-decoder, or a VLM's patches (B, mm_patches, mm_dim)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s_text),
                                    dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s_frames, cfg.frame_dim),
                                              dtype=np.float32)
    else:
        batch["patches"] = rng.standard_normal(
            (b, cfg.mm_patches, cfg.mm_dim), dtype=np.float32)
    return batch


def media_launches(cfg, gen):
    """The kernel launches of one ``generate_batch`` of ``gen`` tokens on
    an encoder-decoder or a VLM.  quant_matmul: seamless' prefill runs
    frame_proj, 6 a encoder layer (q, k, v, o, fc1, fc2) and 10 a decoder
    layer (self and cross attention, fc1, fc2), each decode step 8 a
    decoder layer (the cross attention's q and o: its K/V come from the
    cache); llava's prefill mm_proj, 7 a layer and the lm_head, each
    decode step 7 a layer and the lm_head.  B2 once a (decoder) layer at
    prefill, B1 once a layer a decode step: the encoder's and the cross
    attentions are plain attention, as in the reference."""
    n = cfg.n_layers
    if cfg.family == "encdec":
        qmm = 1 + 16 * n + 8 * n * (gen - 1)
    else:
        qmm = 1 + (7 * n + 1) * gen
    return {"quant_matmul": qmm, "prefill_attention": n,
            "decode_attention": n * (gen - 1),
            "decode_attention_partials": 0, "fake_quant": 0}


def check_quant_matmul_frontend(torch, ops, ref, dev, arch, cfg):
    """B3 at a config's frontend projection, at the rows its path gives
    it (frame_proj: 4 x 512 frames; mm_proj: 2 x 2880 patches): bit for
    bit against its plain version, timed beside it, torch._int_mm and the
    bound.  Returns the JSON entry."""
    if cfg.family == "encdec":
        name, k, m = "frame_proj", cfg.frame_dim, SEAMLESS_B * SEAMLESS_FRAMES
    else:
        name, k, m = "mm_proj", cfg.mm_dim, LLAVA_B * cfg.mm_patches
    n = cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(41)
    x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                        dtype=torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
    act_scale = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())
    got = ops.quant_matmul(x, w_q, w_scale, act_scale)
    want = ref.quant_matmul_ref(x, w_q, w_scale, act_scale)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"quant_matmul {arch} {name} (M={m}, K={k}, N={n}) is not "
            f"bit-exact with its plain version (max |diff| "
            f"{(got.float() - want.float()).abs().max().item()})")

    def call():
        return ops.quant_matmul(x, w_q, w_scale, act_scale)

    ms, call_ms = timed(torch, call)
    plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
        x, w_q, w_scale, act_scale), iters=2, warmup=1)
    nbytes = m * k * 2 + k * n + 4 * n + 4 + m * n * 2
    bnd, by = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
    x_q = torch.clamp(torch.round(x.float() * act_scale), -127, 127).to(
        torch.int8)
    lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_q))
    print(f"  quant_matmul {arch} prefill {name} M={m} K={k} N={n}: "
          f"bit-exact; {ms * 1e3:.1f} us (per call {call_ms * 1e3:.1f} us)  "
          f"plain {plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  _int_mm "
          f"{lib * 1e3:.1f} us")
    return {"name": f"quant_matmul[{arch} {name}, M={m}, K={k}, N={n}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": f"quant_matmul@{arch}", "max_abs_err": 0.0, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib, "library": "torch._int_mm"}


def drive_media_path(torch, ops, A, Engine, build_model, cfg, label, kind,
                     card, walls):
    """An encoder-decoder (seamless-m4t-medium: 4 requests of 512 frames
    and 64 tokens) or a VLM (llava-next-34b: 2 requests of its 2880
    patches and 512 tokens) at full width and ``cfg``'s depth through the
    int8 main path, 32 generated tokens: its engine (weights drawn on the
    card), the programs' warm-up, then the timed run of the captured
    programs and the eager ``loop=True`` driver with the launch counts of
    ``media_launches`` each (no int4, bf16, paged or windowed launch), the
    two drivers' tokens and prefill logits bit for bit; prints the cross
    caches' rows, the build time, the resident int8 bytes, the peak device
    memory and ``replay_busy``.  Returns (engine, the launch counts: all,
    int4, bf16, paged, windowed)."""
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    vlm = cfg.modality == "vlm"
    kw = (dict(calib_len=cfg.mm_patches + 64, calib_batch=LLAVA_CALIB_B)
          if vlm else {})
    engine, build_s = wide_engine(torch, Engine, build_model, cfg, **kw)
    w8 = int8_bytes(torch, engine.serve_params)
    batch = (media_batch(cfg, LLAVA_B, LLAVA_TEXT, 0, 13) if vlm else
             media_batch(cfg, SEAMLESS_B, SEAMLESS_TEXT, SEAMLESS_FRAMES, 13))
    b, s = batch["tokens"].shape
    cache_len = engine._cache_len(s, GEN)
    frames = batch.get("frames")
    caches = engine.init_cache(b, cache_len, **(
        {"enc_len": frames.shape[1]} if frames is not None else {}))
    cross = sorted({c["cross"].capacity for c in caches.values()
                    if "cross" in c})
    del caches
    print(f"[{label}] {cfg.name} full width: "
          + (f"{cfg.n_layers} encoder + {cfg.n_layers} decoder layers, "
             f"frame_dim {cfg.frame_dim}" if frames is not None else
             f"{cfg.n_layers} layers, {cfg.mm_patches} patches of "
             f"{cfg.mm_dim}")
          + f", d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.ffn}, {cfg.mlp_activation}"
          f"), vocab {cfg.vocab}, norm {cfg.norm}"
          f"{'' if cfg.tie_embeddings else ', untied lm_head'}: weights "
          f"drawn on the card, calibration ({kw or 'the default batches'}) "
          f"and int8 conversion in {build_s:.1f} s; "
          f"{engine.n_int8_weights()} int8 weight tensors, {w8 / 1e9:.3f} GB "
          f"int8 resident; peak device memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{label}] {b} requests of {s} tokens"
          + (f" and {frames.shape[1]} frames" if frames is not None else
             f" after {cfg.mm_patches} patches")
          + f", {GEN} generated: decoder caches of {cache_len} positions"
          + (f", cross caches of {cross} rows (the first min({cache_len}, "
             f"{frames.shape[1]}) frames, which decode attends; prefill "
             f"attends all {frames.shape[1]})" if frames is not None else
             f"; decode starts at position {s + cfg.mm_patches}"))
    if frames is not None and cross != [min(cache_len, frames.shape[1])]:
        raise AssertionError(f"cross caches of {cross} rows")
    torch.cuda.reset_peak_memory_stats()
    warm = engine.generate_batch(batch, gen=2)
    expected = media_launches(cfg, GEN)
    zeros = {k: 0 for k in ops.ATTENTION}
    want = (expected, zeros, {"prefill_attention": 0}, zeros,
            {"prefill_attention": 0})

    def run(loop):
        ops.reset_launches()
        res = engine.generate_batch(batch, gen=GEN, loop=loop)
        got = (ops.launch_counts(), ops.int4_launch_counts(),
               ops.bf16_launch_counts(), ops.paged_launch_counts(),
               ops.window_launch_counts())
        driver = "loop=True" if loop else "default"
        print(f"[{label}] ({driver}) kernel launches {got[0]} (expected "
              f"{expected}); int4, bf16 K/V, paged, windowed variants "
              f"{got[1:]}")
        if got != want:
            raise AssertionError(f"{driver}: launch counts {got} != {want}")
        return (res, *got)

    res, *counts = run(False)
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (b, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    if warm.compile_s <= 0.0 or res.compile_s != 0.0:
        raise AssertionError(f"compile_s {warm.compile_s} then "
                             f"{res.compile_s}: the first call must capture, "
                             "the second only replay")
    eager = run(True)[0]
    same = (torch.equal(res.prefill_logits, eager.prefill_logits)
            and torch.equal(res.tokens, eager.tokens))
    decode_ms = res.decode_s / (GEN - 1) * 1e3
    n_prefill = b * (s + (cfg.mm_patches if vlm else 0))
    gap = (res.prefill_logits.float()
           - eager.prefill_logits.float()).abs().max().item()
    print(f"[{label}] graphs vs eager loop=True: prefill logits and {GEN} "
          f"greedy tokens "
          + ("bit-identical" if same else
             f"DIFFER (max |logit diff| {gap}, tokens equal "
             f"{int((res.tokens == eager.tokens).sum())}/"
             f"{res.tokens.numel()})"))
    print(f"[{label}] prefill {b} x {s} tokens"
          + (f" + {frames.shape[1]} frames" if frames is not None else
             f" + {cfg.mm_patches} patches")
          + f": {res.prefill_s * 1e3:.1f} ms = "
          f"{n_prefill / res.prefill_s:.0f} decoder positions/s; decode: "
          f"{decode_ms:.2f} ms per step of {b} tokens on {kind} ({card}); "
          f"graphs captured in {warm.compile_s:.3f} s; eager loop=True: "
          f"prefill {eager.prefill_s * 1e3:.2f} ms, decode "
          f"{eager.decode_s / (GEN - 1) * 1e3:.3f} ms per step; peak device "
          f"memory serving {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB (weights included)")
    if not same:
        raise AssertionError("graphs and the eager driver disagree")
    walls.setdefault(label, {}).update(
        graphs=(res.prefill_s * 1e3, decode_ms, warm.compile_s),
        eager=(eager.prefill_s * 1e3, eager.decode_s / (GEN - 1) * 1e3))
    replay_busy(torch, engine, label, walls)
    return engine, tuple(counts)


def stage_gaps(torch, A, engine, batch, tokens, n_steps, label, rows=None,
               exact=()):
    """Where the card and the CPU part, stage by stage, in an attention
    decoder's prefill and its ``n_steps`` - 1 decode steps teacher-forced
    on ``tokens`` (text or VLM, dense or MoE ffn; a ShardedEngine's under
    its shard scope): each stage (a VLM's ``mm_proj``, each layer's
    pre_norm, attention and ffn residual, the final norm, the last
    position's logits over the real vocabulary) runs on both devices.
    Printed for each call and stage: the largest |difference| of its
    output with each device's own inputs (``total``), with the CPU fed the
    card's input of that stage and, for an attention, a copy of the card's
    cache before it (``local``: what the stage adds by itself), and the
    largest |value| of the card's output; over the requests ``rows`` only
    where given.  The stages in ``exact`` (B3 alone: a VLM's ``mm_proj``,
    an untied readout) must add nothing: local 0 in every call; every
    other stage at most STAGE_LOCAL_ATOL.  Returns ({call: {stage: (total,
    local, largest)}}, the card's and the CPU's logits of each call over
    the real vocabulary: ``cpu_check``'s ``forced``)."""
    import dataclasses

    from repro_torch.launch.engine import model_inputs
    from repro_torch.shard.context import ShardContext, shard_scope

    batch = batch if isinstance(batch, dict) else {"tokens": batch}

    def cache_copy(c):
        return dataclasses.replace(c, **{n: getattr(c, n).to("cpu", copy=True)
                                         for n in ("k", "v", "k_scale",
                                                   "v_scale")})

    def trace(eng, feed=None):
        model = getattr(eng, "base_model", eng.model)
        p, cfg = eng.serve_params, eng.cfg
        if cfg.family == "encdec" or any(
                cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers)):
            raise ValueError(f"{cfg.name}: attention decoders only")
        ctx = A.make_ctx(eng.mode, eng.policy, eng.qparams)
        inputs = model_inputs(cfg, batch, eng.device)
        b, s = inputs["tokens"].shape
        cache = eng.init_cache(b, eng._cache_len(s, GEN))
        outs = {}

        def run(call, name, fn, x, c=None):
            """fn(x, c) -> (y, the cache after); c the stage's cache."""
            if feed is not None:
                x, c = feed[call][name][0].to(eng.device), feed[call][name][2]
            snap = cache_copy(c) if c is not None and feed is None else None
            y, c = fn(x, c)
            outs.setdefault(call, {})[name] = (x.cpu(), y.float().cpu(), snap)
            return y, c

        def layers(call, x, attend):
            for i, blk in enumerate(model.stack.blocks):
                bp = p["stack"][f"layer{i}"]
                h, _ = run(call, f"layer {i} pre_norm", lambda x, _: (
                    blk.pre_norm(bp["pre_norm"], x), None), x)
                a, cache[f"layer{i}"]["attn"] = run(
                    call, f"layer {i} attention",
                    lambda h, c: attend(blk, bp["attn"], h, c), h,
                    cache[f"layer{i}"]["attn"])
                x, _ = run(call, f"layer {i} ffn", lambda x, _: (
                    blk._ffn_residual(bp, x, ctx), None), x + a)
            h, _ = run(call, "final norm", lambda x, _: (
                model.stack.final_norm(p["stack"]["final_norm"], x), None), x)
            run(call, "logits", lambda h, _: (model.readout_fn(p, ctx)(h)[
                ..., :cfg.vocab], None), h[:, -1:])

        sp = getattr(eng, "sp", 1)
        with torch.inference_mode(), shard_scope(ShardContext(sp=sp)):
            x = model.embed(p["embed"], inputs["tokens"])
            if "patches" in inputs:
                pe, _ = run("prefill", "mm_proj", lambda x, _: (
                    model.mm_proj(p["mm_proj"], x, ctx), None),
                    inputs["patches"])
                x = torch.cat([pe.to(cfg.dtype), x], dim=1)
            layers("prefill", x, lambda blk, bp, h, c: blk.attn.prefill(
                bp, h, c, ctx))
            tok = torch.as_tensor(tokens).to(eng.device)
            for i in range(n_steps - 1):
                pos = s + eng._prefix_len() + i
                layers(f"step {i + 1}", model.embed(p["embed"],
                                                    tok[:, i:i + 1]),
                       lambda blk, bp, h, c, pos=pos: blk.attn.decode(
                           bp, h, c, pos, ctx))
        return outs

    card = trace(engine)
    cpu_engine = engine.to("cpu")
    cpu, fed = trace(cpu_engine), trace(cpu_engine, feed=card)
    pick = (lambda t: t) if rows is None else (lambda t: t[list(rows)])
    got = {}
    for call, stages in card.items():
        got[call] = {k: ((pick(y) - pick(cpu[call][k][1])).abs().max().item(),
                         (pick(y) - pick(fed[call][k][1])).abs().max().item(),
                         pick(y).abs().max().item())
                     for k, (_, y, _) in stages.items()}
        print(f"[{label}] {call} stage by stage, card vs CPU"
              + ("" if rows is None else f" (requests {list(rows)})")
              + ": largest |diff| total / local (the CPU fed the card's "
              "input and cache) / largest |value|: " + "; ".join(
                  f"{k} {t:.4f} / {lo:.4f} / {m:.3f}"
                  for k, (t, lo, m) in got[call].items()))
    bad = {(call, k): v[1] for call, st in got.items() for k, v in st.items()
           if k in exact and v[1]}
    if bad:
        raise AssertionError(f"B3's stages differ on the same input: {bad}")
    worst = max(v[1] for st in got.values() for v in st.values())
    if worst > STAGE_LOCAL_ATOL:
        raise AssertionError(f"a stage differs by {worst} on the same input "
                             f"(limit {STAGE_LOCAL_ATOL})")
    return got, tuple([run[call]["logits"][1][:, -1] for call in card]
                      for run in (card, cpu))


def check_media_cpu(torch, ops, A, Engine, build_model, cfg, label):
    """A full-width copy of depth 2 (seamless: 2 encoder and 2 decoder
    layers; llava: 2 layers and ``CPU_MM_PATCHES`` patches, an untied
    readout served on the last block's ``wq`` thresholds): 1 request of 64
    tokens (and ``CPU_FRAMES`` frames, past the cross cache's 128 rows),
    8 generated tokens through the captured programs with the launches of
    ``media_launches``, held against the same engine on the CPU
    (``cpu_check``: tokens within ``LOGIT_ATOL``, logits within
    ``WIDE_LOGIT_ATOL``; llava's prefill and steps first stage by stage,
    ``stage_gaps``)."""
    free_card(torch)
    over = dict(n_layers=2)
    vlm = cfg.modality == "vlm"
    if vlm:
        over["mm_patches"] = CPU_MM_PATCHES
    cut = cfg.replace(**over)
    kw = dict(calib_len=CPU_MM_PATCHES + 64, calib_batch=LLAVA_CALIB_B) \
        if vlm else {}
    engine, build_s = wide_engine(torch, Engine, build_model, cut, seed=1,
                                  **kw)
    engine = readout_thresholds(Engine, engine, label)
    gen = 8
    batch = media_batch(cut, 1, 64, CPU_FRAMES, 11)
    engine.generate_batch(batch, gen=gen)          # captures
    ops.reset_launches()
    res = engine.generate_batch(batch, gen=gen)
    got, want = ops.launch_counts(), media_launches(cut, gen)
    print(f"[{label}] {cfg.name} at full width, {over} (built in "
          f"{build_s:.1f} s): 1 x 64 tokens"
          + (f" + {CPU_MM_PATCHES} patches" if vlm else
             f" + {CPU_FRAMES} frames")
          + f", {gen} tokens {res.tokens.tolist()}; launches {got} "
          f"(expected {want})")
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    n_check = CPU_CHECK_STEPS.get(cfg.name, gen)
    forced = stage_gaps(torch, A, engine, batch, res.tokens.cpu(), n_check,
                        label, exact=("mm_proj", "logits"))[1] if vlm else None
    cpu_check(torch, A, engine, batch, res.tokens.cpu(), LOGIT_ATOL, label,
              n_check=n_check, logit_tol=WIDE_LOGIT_ATOL[cfg.name],
              forced=forced)


class GatherCount:
    """Counts, while active, every contiguous gather of a page pool
    (``PagedCache.dense_view`` and the plain versions' ``gather_pages``):
    the paged path on the card must run none."""

    def __init__(self, paged_cls, ref):
        self.paged_cls, self.ref, self.n = paged_cls, ref, 0

    def __enter__(self):
        self.saved = (self.paged_cls.dense_view, self.ref.gather_pages)
        view, gather = self.saved

        def counted_view(cache, *a, **kw):
            self.n += 1
            return view(cache, *a, **kw)

        def counted_gather(*a, **kw):
            self.n += 1
            return gather(*a, **kw)

        self.paged_cls.dense_view = counted_view
        self.ref.gather_pages = counted_gather
        return self

    def __exit__(self, *exc):
        self.paged_cls.dense_view, self.ref.gather_pages = self.saved


def layout_twin(Engine, engine, layout, page=PAGE):
    """The same weights and thresholds served through another cache layout,
    with chunked prefill in chunks of CHUNK (pages of ``page``)."""
    return Engine(engine.model, engine.cfg, engine.policy,
                  engine.serve_params, engine.qparams, device=engine.device,
                  mode=engine.mode, cache_layout=layout, page_size=page,
                  prefill_chunk=CHUNK)


def drive_paged_path(torch, ops, ref, Engine, PagedCache, engine, prompts,
                     label, kind, card, page=PAGE, A=None, walls=None):
    """4 x 512 prompts for 32 tokens through a paged cache (pages of
    ``page``) with chunked prefill, through the captured programs: every
    attention launch through the paged variants, no gather of the pool,
    logits and tokens bit-identical to the same engine with a dense cache
    and to the eager ``loop=True`` driver on the paged cache.  A bf16 pool:
    prefill through B2's paged bf16 branch, decode in plain attention over
    the gathered pool (one gather a layer and step, as in the reference);
    a float32 pool (a float32 config's) the same through B2's float32
    branch, graphs and eager bit for bit with no near-tie allowed.
    Returns the timed run's result and its (all, int4, float32, paged)
    launch counts."""
    paged = layout_twin(Engine, engine, "paged", page)
    dense = layout_twin(Engine, engine, "dense")
    warm = paged.generate_batch({"tokens": prompts}, gen=2)   # warm-up
    ops.reset_launches()
    with GatherCount(PagedCache, ref) as replayed:
        res = paged.generate_batch({"tokens": prompts}, gen=GEN)
    counts, int4 = ops.launch_counts(), ops.int4_launch_counts()
    pg, bf16 = ops.paged_launch_counts(), ops.bf16_launch_counts()
    f32c = ops.f32_launch_counts()
    n_layers, chunks = engine.cfg.n_layers, PROMPT // CHUNK
    kv8 = engine.policy.kv_int8
    f32 = engine.cfg.dtype == torch.float32
    attn = {"prefill_attention": n_layers * chunks,
            "decode_attention": n_layers * (GEN - 1) if kv8 else 0,
            "decode_attention_partials": 0}
    expected = {"quant_matmul": 7 * n_layers * (chunks + GEN - 1)
                if engine.mode == "int8" else 0, **attn, "fake_quant": 0}
    int4_expected = attn if kv8 and engine.policy.kv_bits == 4 else {
        k: 0 for k in attn}
    bf16_expected = {"prefill_attention":
                     0 if kv8 or f32 else attn["prefill_attention"]}
    f32_expected = {"quant_matmul": 0, "prefill_attention":
                    attn["prefill_attention"] if f32 and not kv8 else 0}
    print(f"[{label}] kernel launches {counts} (expected {expected}); paged "
          f"variants {pg} (expected {attn}); int4 variants {int4}; bf16 K/V "
          f"variants {bf16} (expected {bf16_expected}); float32 variants "
          f"{f32c} (expected {f32_expected})")
    if (counts, pg, int4, bf16, f32c) != (expected, attn, int4_expected,
                                          bf16_expected, f32_expected):
        raise AssertionError(f"launch counts {counts} / paged {pg} / int4 "
                             f"{int4} / bf16 {bf16} / float32 {f32c}")
    if warm.compile_s <= 0.0 or res.compile_s != 0.0 or replayed.n:
        raise AssertionError(f"compile_s {warm.compile_s} then "
                             f"{res.compile_s}, {replayed.n} gathers called: "
                             "the first call must capture, the second only "
                             "replay")
    # the eager driver runs the Python of every step: its pool gathers are
    # those the captured decode step replays
    gathers_expected = 0 if kv8 else n_layers * (GEN - 1)
    with GatherCount(PagedCache, ref) as gathers:
        eager = paged.generate_batch({"tokens": prompts}, gen=GEN, loop=True)
    print(f"[{label}] pool gathers of the eager driver {gathers.n} (expected "
          f"{gathers_expected}); none called by the replays")
    if gathers.n != gathers_expected:
        raise AssertionError(f"pool gathers {gathers.n}, expected "
                             f"{gathers_expected}")
    compare_programs(torch, A, paged, prompts, res, eager, label, f32)
    if walls is not None:
        walls[label] = {"graphs": (res.prefill_s * 1e3,
                                   res.decode_s / (GEN - 1) * 1e3,
                                   warm.compile_s),
                        "eager": (eager.prefill_s * 1e3,
                                  eager.decode_s / (GEN - 1) * 1e3)}
    want = dense.generate_batch({"tokens": prompts}, gen=GEN)
    if not (torch.equal(res.prefill_logits, want.prefill_logits)
            and torch.equal(res.tokens, want.tokens)):
        diff = (res.prefill_logits.float() - want.prefill_logits.float()).abs()
        raise AssertionError(
            f"paged and dense caches disagree: prefill logits max |diff| "
            f"{diff.max().item()}, tokens equal "
            f"{int((res.tokens == want.tokens).sum())}/{res.tokens.numel()}")
    cache = paged.init_cache(B, paged._cache_len(PROMPT, GEN))
    pool = sum((c["attn"].k.numel() + c["attn"].v.numel())
               * c["attn"].k.element_size() + 4 * c["attn"].table.numel()
               for c in cache.values())
    print(f"[{label}] prefill {B}x{PROMPT} tokens in chunks of {CHUNK}: "
          f"{res.prefill_s * 1e3:.1f} ms = {B * PROMPT / res.prefill_s:.0f} "
          f"tokens/s (eager loop=True {eager.prefill_s * 1e3:.1f} ms); decode "
          f"{res.decode_s / (GEN - 1) * 1e3:.2f} ms per step (eager "
          f"{eager.decode_s / (GEN - 1) * 1e3:.2f}); graphs captured in "
          f"{warm.compile_s:.3f} s; pool {pool} bytes ({len(cache)} layers, "
          f"pages of {page}) on {kind} ({card}); prefill logits and {GEN} "
          "greedy tokens bit-identical to the dense cache")
    return res, counts, int4, f32c, pg


def teacher_forced_gap(torch, A, ST, engine, prompt, tokens):
    """Batch-1 chunked prefill + decode of ``prompt`` fed ``tokens``: the
    first step whose argmax is not ``tokens[step]``, with the logit gap
    between the two; None when every argmax agrees."""
    with torch.inference_mode():
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        toks = torch.as_tensor(prompt, device=engine.device)[None]
        cache = engine.init_cache(1, engine._cache_len(toks.shape[1],
                                                       len(tokens)))
        padded, lengths = ST.pad_for_chunked_prefill(toks, CHUNK)
        logits, cache = ST.make_prefill_step(
            engine.model, engine.policy, prefill_chunk=CHUNK,
            mode=engine.mode)(
            engine.serve_params, engine.qparams, {"tokens": padded}, cache,
            lengths)
        for i, t in enumerate(tokens):
            row = logits[0, -1].float()
            pick = int(row.argmax())
            if pick != t:
                return i, (row[pick] - row[t]).item()
            logits, cache = engine.model.decode_step(
                engine.serve_params, torch.tensor([[t]], device=engine.device),
                cache, toks.shape[1] + i, ctx)
    return None


def scheduler_requests(Request, vocab, n_requests=N_REQUESTS, extra=None):
    """(lengths, requests): the [scheduler]'s ragged requests, prompts of
    64-PROMPT tokens and GEN generated tokens each, from seed 3; ``extra``
    maps a rid to more Request fields (priority, deadline, arrival)."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(64, PROMPT + 1, n_requests)
    extra = extra or {}
    return lengths, [Request(rid=i, tokens=rng.integers(0, vocab, n,
                                                        dtype=np.int32),
                             max_gen=GEN, **extra.get(i, {}))
                     for i, n in enumerate(lengths)]


def check_scheduler(torch, ops, A, ST, Engine, Request, engine, kind, card,
                    n_requests=N_REQUESTS, n_alone=4, label="scheduler"):
    """``n_requests`` ragged requests through 8 slots of the paged cache;
    every one must finish by its 32-token budget, and ``n_alone`` of them
    re-served alone through batch-1 ``generate_batch`` (dense cache, same
    chunks) must give the same tokens or first differ at a near-tie.
    Returns (launch counts, bf16-K/V launch counts, the completions, paged
    launch counts)."""
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab, n_requests)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = engine.generate(reqs, max_slots=SLOTS, block_steps=BLOCK_STEPS,
                           eos_id=-1)
    wall = time.perf_counter() - t0
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    bf16 = ops.bf16_launch_counts()
    sched = engine._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    n_layers = engine.cfg.n_layers
    steps = calls["decode"] * BLOCK_STEPS
    bad = [(c.rid, c.status, c.finished_by, len(c.tokens)) for c in done
           if (c.status, c.finished_by, len(c.tokens)) != ("ok", "budget",
                                                           GEN)]
    serve = wall - sec["compile"]
    print(f"[{label}] {len(done)} requests (prompts {lengths.min()}-"
          f"{lengths.max()} tokens, {GEN} generated each) through {SLOTS} "
          f"slots in {serve:.2f} s after the capture: {len(done) / serve:.2f}"
          f" requests/s, {len(done) * GEN / serve:.1f} generated tokens/s; "
          f"admission "
          f"{sec['admit'] / calls['prefill'] * 1e3:.1f} ms per request; "
          f"decode {sec['decode'] / calls['decode'] * 1e3:.1f} ms per block "
          f"of {BLOCK_STEPS} steps = {sec['decode'] / steps * 1e3:.2f} ms per "
          f"step on {kind} ({card}); admission prefill and decode block "
          f"captured in {sec['compile']:.3f} s (the run's first "
          f"{sec['compile']:.3f} s of {wall:.2f})")
    if sec["compile"] <= 0.0:
        raise AssertionError("the scheduler captured no program")
    # the device's share of an admission and of a block: replays of the
    # two programs after the run (the block rewrites dead entries only)
    adm_busy, block_busy = (program_busy(torch, sched._admission),
                            program_busy(torch, sched._block))
    if adm_busy is not None and block_busy is not None:
        print(f"[{label}] device busy (profiled replays): admission prefill "
              f"{adm_busy:.2f} ms of the {sec['admit'] / calls['prefill'] * 1e3:.1f}"
              f" ms admission wall; decode block {block_busy:.2f} ms of "
              f"{sec['decode'] / calls['decode'] * 1e3:.1f} ms")
    from repro_torch.launch.graphs import WARMUP

    # admissions prefill a dense batch-1 cache; decode over a bf16 pool is
    # plain attention.  The decode block's capture, in this run, first ran
    # it WARMUP times eagerly (every slot idle): real launches, counted
    decode = (n_layers * (steps + WARMUP * BLOCK_STEPS)
              if engine.policy.kv_int8 else 0)
    print(f"[{label}] calls {calls}; kernel launches {counts}; paged "
          f"variants {pg} (decode expected {decode}: {steps} steps and the "
          f"capture's {WARMUP} warm-up blocks); bf16 K/V variants "
          f"{bf16}; health {sched.health_stats()}")
    if len(done) != n_requests or bad:
        raise AssertionError(f"{len(done)} completions; not ok/budget/{GEN}: "
                             f"{bad}")
    if pg != {"prefill_attention": 0, "decode_attention": decode,
              "decode_attention_partials": 0}:
        raise AssertionError(f"paged launches {pg}")
    if (bf16["prefill_attention"] > 0) == engine.policy.kv_int8:
        raise AssertionError(f"bf16 K/V launches {bf16} with kv_int8="
                             f"{engine.policy.kv_int8}")
    dense = layout_twin(Engine, engine, "dense")
    by_rid = {c.rid: c for c in done}
    for r in range(n_alone):
        alone = dense.generate_batch({"tokens": reqs[r].tokens[None]},
                                     gen=GEN).tokens[0].tolist()
        got = by_rid[r].tokens
        if alone == got:
            print(f"[{label}] request {r} ({lengths[r]} tokens) alone: "
                  f"{GEN} tokens equal")
            continue
        forced = teacher_forced_gap(torch, A, ST, dense, reqs[r].tokens,
                                    got)
        if forced is None:
            raise AssertionError(
                f"request {r}: batch-1 generate_batch gives other tokens, "
                "but teacher-forced on the scheduler's tokens every argmax "
                "agrees")
        step, gap = forced
        print(f"[{label}] request {r} ({lengths[r]} tokens) alone: first "
              f"differs at token {step}, where the batch-1 logits put the "
              f"scheduler's token {gap:.4f} below their argmax (near-tie "
              f"tolerance {LOGIT_ATOL})")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"request {r}: the scheduler's token {step} "
                                 f"is {gap} below the batch-1 argmax")
    return counts, bf16, done, pg


# the float32 configs (the reference's own configs built with dtype
# float32, which its engine and tests serve): smollm-135m in the two modes
# over a float32 cache at full depth, its paged twin at F32_PAGED_LAYERS,
# granite-moe-3b-a800m over its default int8 cache at MOE_F32_LAYERS of 32
# (the script's time)
F32_MODES = {"int8_w_bf16_kv": dict(kv_int8=False),
             "bf16_w_bf16_kv": dict(fp=True, kv_int8=False)}
F32_PAGED_LAYERS, MOE_F32_LAYERS = 10, 4
# the float32 paths' first request teacher-forced, card vs CPU: the logits'
# limits, about twice the readings on an H100 at 700 W at these seeds.
# int8_w_bf16_kv read 0.1101 (its int8 layers round to bf16 as the bf16
# modes do, and a bf16 step crosses int8 steps in later layers): the bf16
# modes' 0.25.  bf16_w_bf16_kv (float32 weights and sums) read 7.3e-6, and
# granite-moe's depth-2 copy 1.4e-6 over its 16 held pairs (its int8
# readout and experts sum exactly; float32 elsewhere).
F32_LOGIT_ATOL = {"int8_w_bf16_kv": LOGIT_ATOL, "bf16_w_bf16_kv": 1.5e-5,
                  "granite-moe-3b-a800m": 3e-6}


def drive_f32_path(torch, ops, A, Engine, cfg, prompts, mode, label, kind,
                   card, walls):
    """smollm-135m built with dtype float32 (``cfg``) in ``mode`` (int8 or
    float32 weights over a float32 cache) at full width and depth: its main
    path (``drive_main_path``: graphs and ``loop=True`` bit for bit, B2's
    float32 branch once a layer and prefill, decode in plain attention over
    the float32 cache, as the reference's), then the first request teacher-
    forced against the same engine on the CPU (``cpu_check``, tokens equal
    or near-ties within ``F32_LOGIT_ATOL``, logits within it).  Returns
    (all, float32) launch counts of the timed run."""
    t0 = time.perf_counter()
    eng = Engine.from_checkpoint(cfg=cfg, smoke=False, **F32_MODES[mode])
    torch.cuda.synchronize()
    cache = next(iter(eng.init_cache(1, 128).values()))["attn"]
    print(f"[{label}] {cfg.name} float32, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, {mode} (engine mode {eng.mode}): built in "
          f"{time.perf_counter() - t0:.1f} s; {eng.n_int8_weights()} int8 "
          f"weight tensors; cache {cache.k.dtype}")
    if cache.k.dtype != torch.float32:
        raise AssertionError(f"the cache holds {cache.k.dtype}, not float32")
    res, counts, *_, f32 = drive_main_path(torch, ops, eng, prompts, label,
                                           kind, card, 1, walls, A,
                                           strict=True)
    print(f"[{label}] B2 float32 launches per prefill: "
          f"{f32['prefill_attention']} ({cfg.n_layers} layers); B3 "
          f"{counts['quant_matmul']}, B1 {counts['decode_attention']}")
    tol = F32_LOGIT_ATOL[mode]
    cpu_check(torch, A, eng, prompts[:1], res.tokens[:1].cpu(), tol,
              f"{label} cpu check")
    return counts, f32


def drive_f32_paged(torch, ops, ref, A, Engine, PagedCache, build_model,
                    cfg, prompts, label, kind, card, walls):
    """The float32 int8_w_bf16_kv engine at ``F32_PAGED_LAYERS`` layers
    through a paged float32 cache (pages of ``PAGE``, chunks of ``CHUNK``,
    ``drive_paged_path``: B2's paged float32 branch a layer and chunk,
    bit for bit with the chunked dense cache and the eager driver); its
    tokens against the same weights' one-shot dense engine: equal, or
    near-ties (that engine teacher-forced on the paged tokens puts them
    within ``F32_LOGIT_ATOL`` of its argmax).  Returns (all, float32,
    paged) launch counts."""
    cut = cfg.replace(n_layers=F32_PAGED_LAYERS)
    eng = Engine.from_checkpoint(cfg=cut, smoke=False,
                                 **F32_MODES["int8_w_bf16_kv"])
    res, counts, _, f32, pg = drive_paged_path(
        torch, ops, ref, Engine, PagedCache, eng, prompts, label, kind, card,
        PAGE, A, walls)
    toks = res.tokens
    dense = eng.generate_batch({"tokens": prompts}, gen=GEN).tokens
    same = int((dense == toks).sum())
    gap = forced_gap(torch, A, eng, prompts, toks)
    tol = F32_LOGIT_ATOL["int8_w_bf16_kv"]
    print(f"[{label}] paged chunked tokens vs the one-shot dense engine's "
          f"at {F32_PAGED_LAYERS} layers: equal {same}/{toks.numel()}; the "
          f"dense engine teacher-forced on the paged tokens puts them at "
          f"most {gap:.4f} below its argmax (near-tie limit {tol})")
    if not gap <= tol:
        raise AssertionError(f"paged and dense float32 engines disagree by "
                             f"{gap}")
    return counts, f32, pg


def drive_moe_f32(torch, ops, A, Engine, build_model, get_config, label,
                  kind, card, walls):
    """granite-moe-3b-a800m built with dtype float32 at full width and
    ``MOE_F32_LAYERS`` layers (weights drawn on the card), int8 weights
    over the default int8 cache: its main path (graphs == ``loop=True``
    bit for bit; every expert product through B3's float32 output, 3 x 40
    launches a layer and pass; the attention projections through B3's bf16
    output, as the reference's Dense layers), then a depth-2 float32 copy
    against the CPU with the routing flips counted (``check_arch_cpu``).
    Returns (all, paged, float32) launch counts of the timed run."""
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch).replace(dtype=torch.float32,
                                   n_layers=MOE_F32_LAYERS)
    free_card(torch)
    engine, build_s = wide_engine(torch, Engine, build_model, cfg)
    print(f"[{label}] {arch} float32 full width, {MOE_F32_LAYERS} of 32 "
          f"layers, {cfg.n_experts} experts top-{cfg.top_k}: weights drawn "
          f"on the card, calibration and int8 conversion in {build_s:.1f} "
          f"s; {engine.n_int8_weights()} int8 weight tensors")
    prompts = np.random.default_rng(sum(map(ord, cfg.name))).integers(
        0, cfg.vocab, (B, PROMPT), dtype=np.int32)
    _, counts, _, _, paged, _, f32 = drive_main_path(
        torch, ops, engine, prompts, label, kind, card, walls=walls, A=A,
        strict=True)
    per_step = f32["quant_matmul"] // GEN
    print(f"[{label}] B3 float32-output launches per pass (prefill or "
          f"decode step): {per_step} (3 x {cfg.n_experts} experts x "
          f"{MOE_F32_LAYERS} layers); bf16-output launches (attention) "
          f"{counts['quant_matmul'] - f32['quant_matmul']}")
    del engine
    check_arch_cpu(torch, ops, A, Engine, build_model,
                   get_config(arch).replace(dtype=torch.float32),
                   f"{label} cpu check", logit_tol=F32_LOGIT_ATOL[arch])
    return counts, paged, f32


def check_moe_scheduler(torch, ops, A, ST, Engine, Request, build_model,
                        engine, kind, card, label):
    """An MoE engine's weights and thresholds, its first
    ``MOE_SCHEDULER_LAYERS`` layers, through ``check_scheduler`` (16
    ragged requests, 8 slots of the paged cache, chunks of 128,
    ``MOE_ALONE`` re-served alone), at drop-free capacity: capacity
    factor n_experts / top_k gives every expert room for every token of a
    group, so the admission's chunks, the slot batch's one-token groups
    and batch-1's chunks route each token alike.  With drops the
    reference's own semantics make each grouping drop other tokens, and
    equivalence across groupings holds only without them
    (``tests/test_serving.py``).
    Returns ``check_scheduler``'s result."""
    n = MOE_SCHEDULER_LAYERS
    cut = cut_engine(Engine, build_model, engine, n,
                     capacity_factor=engine.cfg.n_experts / engine.cfg.top_k)
    print(f"[{label}] drop-free capacity: capacity factor "
          f"{cut.cfg.capacity_factor} (n_experts / top_k; the engine above "
          f"serves {engine.cfg.capacity_factor}), so the scheduler's "
          f"groupings and batch-1's drop no token; the same weights and "
          f"thresholds, its first {n} of {engine.cfg.n_layers} layers")
    sched = layout_twin(Engine, cut, "paged")
    return check_scheduler(torch, ops, A, ST, Engine, Request, sched, kind,
                           card, n_alone=MOE_ALONE, label=label)


def check_sp_scheduler(torch, ops, A, ST, Engine, ShardedEngine, Request,
                       engine, kind, card):
    """8 ragged requests (prompts of 64-512 tokens, 16 generated each)
    through 4 slots of the sp engine, chunked prefill in chunks of CHUNK:
    every decode step launches the partials kernel once per shard and
    layer.  The completions are held against the unsharded scheduler on
    the same weights and thresholds: equal, or first different where the
    unsharded engine, teacher-forced on the sp tokens, puts the sp token
    within ``LOGIT_ATOL`` of its argmax (a near-tie: both attend the
    dequantized int8 cache, in another float order).  Returns the launch
    counts."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(64, PROMPT + 1, SP_REQUESTS)
    reqs = [Request(rid=i, tokens=rng.integers(0, engine.cfg.vocab, n,
                                               dtype=np.int32),
                    max_gen=SP_GEN) for i, n in enumerate(lengths)]
    weights = (engine.cfg, engine.policy, engine.serve_params,
               engine.qparams)
    sharded = ShardedEngine(engine.base_model, *weights,
                            device=engine.device, sp=SP,
                            prefill_chunk=CHUNK)
    flat = Engine(engine.base_model, *weights, device=engine.device,
                  prefill_chunk=CHUNK)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = sharded.generate(reqs, max_slots=SP_SLOTS,
                            block_steps=BLOCK_STEPS)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    sched = sharded._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    n_layers = engine.cfg.n_layers
    steps = calls["decode"] * BLOCK_STEPS
    print(f"[sp scheduler] {len(done)} requests (prompts {lengths.min()}-"
          f"{lengths.max()} tokens, {SP_GEN} generated each) through "
          f"{SP_SLOTS} slots, sp={SP}, in {wall:.2f} s: "
          f"{len(done) / wall:.2f} requests/s; admission "
          f"{sec['admit'] / calls['prefill'] * 1e3:.1f} ms per request; "
          f"decode {sec['decode'] / steps * 1e3:.2f} ms per step on {kind} "
          f"({card}); calls {calls}; kernel launches {counts} (partials "
          f"expected {n_layers * steps * SP})")
    bad = [(c.rid, c.status, c.finished_by, len(c.tokens)) for c in done
           if (c.status, c.finished_by, len(c.tokens)) != ("ok", "budget",
                                                           SP_GEN)]
    if len(done) != SP_REQUESTS or bad:
        raise AssertionError(f"{len(done)} completions; not "
                             f"ok/budget/{SP_GEN}: {bad}")
    want_counts = {"prefill_attention": 0, "decode_attention": 0,
                   "decode_attention_partials": n_layers * steps * SP}
    if {k: counts[k] for k in want_counts} != want_counts:
        raise AssertionError(f"launch counts {counts}, expected "
                             f"{want_counts}")
    t0 = time.perf_counter()
    base = {c.rid: c.tokens for c in flat.generate(
        reqs, max_slots=SP_SLOTS, block_steps=BLOCK_STEPS)}
    base_s = time.perf_counter() - t0
    equal = 0
    for c in done:
        if c.tokens == base[c.rid]:
            equal += 1
            continue
        first = next(i for i, (a, b) in enumerate(zip(c.tokens,
                                                      base[c.rid])) if a != b)
        forced = teacher_forced_gap(torch, A, ST, flat, reqs[c.rid].tokens,
                                    c.tokens)
        if forced is None:
            print(f"[sp scheduler] request {c.rid}: the unsharded scheduler "
                  f"first differs at token {first}; the unsharded engine "
                  f"batch-1, teacher-forced, agrees with every sp token")
            continue
        step, gap = forced
        print(f"[sp scheduler] request {c.rid}: first differs at token "
              f"{first}; teacher-forced, the unsharded engine puts the sp "
              f"token {step} {gap:.4f} below its argmax (near-tie tolerance "
              f"{LOGIT_ATOL})")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"request {c.rid}: the sp token {step} is "
                                 f"{gap} below the unsharded argmax")
    print(f"[sp scheduler] completions equal to the unsharded scheduler's "
          f"({base_s:.2f} s) for {equal}/{len(done)} requests")
    return counts


def drive_sp_phase(torch, ops, A, ST, SG, prng, ShardedEngine, build_model,
                   engine, batch, label, kind, card, *, greedy=None,
                   cpu_over=None, **kw):
    """The weights and thresholds of ``engine`` (a family's own phase: no
    new draw; an untied readout served on the last block's ``wq``
    thresholds, ``readout_qparams``) as ``ShardedEngine(sp=SP)`` over
    dense caches, with ``kw`` (the speculative strategy): ``batch`` (a
    token or media batch) for GEN tokens through its programs, uncaptured
    under sp, after a warm-up call, the launch counts zeroed just before and read just
    after: B4 once per shard and global layer a decode step over a
    quantized cache (n_global x (GEN - 1) x SP), none over a float cache
    or in speculative verify windows (plain attention there, as in the
    reference), no B1 and no B2, B3 as on the unsharded path.  Prints
    prefill ms, decode ms a step (a verify window) and the launches.  With
    ``greedy`` (the card's sp greedy tokens of the same batch) the
    speculative tokens must equal them up to a near-tie (``LOGIT_ATOL``
    below the argmax of the greedy sp steps teacher-forced on them), the
    eager window steps must give them bit for bit, and the windows and
    acceptance are printed.  Then the timed run's first request and its
    tokens on the card, held against the same sp engine on the CPU over
    SP_CPU_STEPS teacher-forced steps (``cpu_check``: tokens under the
    near-tie rule, logits within ``SP_LOGIT_ATOL``, ``WIDE_LOGIT_ATOL`` or
    LOGIT_ATOL).  With ``cpu_over`` (stablelm, granite-moe, llava: the CPU
    cannot hold their timed shapes in the script's time, see
    SP_CPU_LAYERS) the whole timed run is held
    against the same engine on the card with the plain versions instead,
    and a short request (1 x SP_CPU_PROMPT tokens with a VLM's
    CPU_MM_PATCHES patches; an MoE config's ``MOE_CPU_REQUESTS`` x
    ``MOE_CPU_PROMPT``) against the CPU through a twin of the same weights
    whose config takes ``cpu_over`` (the first ``n_layers``; a VLM's fewer
    patches); a dense twin is traced stage by stage (``stage_gaps``, every
    stage's own gap within STAGE_LOCAL_ATOL, whose runs the check reuses),
    and a VLM's then held unsharded (sp=1) against the CPU on the same
    request.
    An MoE
    engine is held up to each request's first routing flip
    (``moe_held``).  Returns the launch counts and their int4 variants'.
    """
    cfg = engine.cfg
    base = getattr(engine, "base_model", engine.model)
    qparams = readout_qparams(cfg, engine.qparams)
    kw = dict(device=engine.device, sp=SP, mode=engine.mode,
              cache_layout="dense", **kw)
    sharded = ShardedEngine(base, cfg, engine.policy, engine.serve_params,
                            qparams, **kw)
    speculative = sharded.decode_strategy == "speculative"
    media = cfg.family == "encdec" or cfg.modality == "vlm"
    sharded.generate_batch(batch, gen=2)                 # warm-up
    ops.reset_launches()
    res = sharded.generate_batch(batch, gen=GEN)
    got, int4 = ops.launch_counts(), ops.int4_launch_counts()
    _, n_global, per_token = path_layers(cfg)
    qmm = media_launches(cfg, GEN)["quant_matmul"] if media else (
        per_token * GEN)
    quantized = bool(engine.policy.kv_int8)
    want = {"quant_matmul": qmm if engine.mode == "int8" else 0,
            "prefill_attention": 0, "decode_attention": 0,
            "decode_attention_partials":
                n_global * (GEN - 1) * SP if quantized and not speculative
                else 0,
            "fake_quant": 0}
    b, s = batch["tokens"].shape
    per = "verify window" if speculative else "step"
    print(f"[{label}] {cfg.name} ({cfg.n_layers} layers, full width), sp="
          f"{SP}, {engine.mode} weights, "
          f"{'int8' if quantized else 'bf16'} KV cache"
          f"{', speculative spec_k ' + str(SPEC_K) if speculative else ''}: "
          f"prefill {b} x {s}"
          + (f" + {batch['frames'].shape[1]} frames" if "frames" in batch
             else f" + {cfg.mm_patches} patches" if "patches" in batch
             else "")
          + f" {res.prefill_s * 1e3:.1f} ms; decode "
          f"{res.decode_s / (GEN - 1) * 1e3:.2f} ms per {per} of {b} "
          f"requests (uncaptured programs) on {kind} ({card}); kernel "
          f"launches "
          f"{got} (expected {want}): B4 "
          f"{got['decode_attention_partials']}")
    if got != want:
        raise AssertionError(f"launch counts {got} != {want}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (b, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    if greedy is not None:
        eager, stats = spec_eager(torch, ST, SG, prng, sharded,
                                  batch["tokens"])
        if not torch.equal(eager.cpu(), toks):
            raise AssertionError("the sp speculative windows run step by "
                                 "step disagree with generate_batch")
        same = int((toks == greedy.cpu()).sum())
        gap = 0.0 if same == greedy.numel() else forced_gap(
            torch, A, sharded, batch["tokens"], res.tokens)
        print(f"[{label}] tokens equal the sp greedy path's {same}/"
              f"{greedy.numel()} (teacher-forced gap of the speculative "
              f"tokens below the greedy sp argmax {gap:.4f}, near-tie "
              f"tolerance {LOGIT_ATOL}); the windows step by step give them "
              f"bit for bit; windows {stats['windows']}, with a live row "
              f"{stats['windows_live']}; {stats['tokens_per_window']:.3f} "
              f"tokens per row window, acceptance "
              f"{stats['acceptance_rate']:.3f}")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"speculative tokens {gap} below the "
                                 "greedy sp argmax")
    moe = cfg.ffn == "moe"
    tol = SP_LOGIT_ATOL.get(cfg.name,
                            WIDE_LOGIT_ATOL.get(cfg.name, LOGIT_ATOL))

    def held_check(eng, prompts, toks, lab, twin="CPU", **kw):
        b, s = np.shape(prompts["tokens"])
        if not moe:
            return cpu_check(torch, A, eng, prompts, toks, LOGIT_ATOL, lab,
                             n_check=SP_CPU_STEPS, logit_tol=tol, **kw)
        with moe_held(lab, eng.cfg, b, s, SP_CPU_STEPS, twin) as held:
            cpu_check(torch, A, eng, prompts, toks, LOGIT_ATOL, lab,
                      n_check=SP_CPU_STEPS, logit_tol=tol, held=held, **kw)

    if not cpu_over:
        # the timed run's first request and its tokens on the CPU
        first = {k: v[:1] for k, v in batch.items()}
        held_check(sharded, first, toks[:1], label)
        return got, int4
    # the timed run whole against the card's plain versions, then a short
    # request through a cut twin of the same weights on the CPU
    held_check(sharded, batch, toks, f"{label} plain",
               twin="the card's plain versions", plain_ops=ops)
    cpu_cfg = cfg.replace(**cpu_over)
    params = engine.serve_params
    if "n_layers" in cpu_over:
        stack = params["stack"]
        params = {**params, "stack": {
            **{f"layer{i}": stack[f"layer{i}"]
               for i in range(cpu_cfg.n_layers)},
            "final_norm": stack["final_norm"]}}
    twin = ShardedEngine(build_model(cpu_cfg), cpu_cfg, engine.policy,
                         params, readout_qparams(cpu_cfg, engine.qparams),
                         **kw)
    b, s = ((MOE_CPU_REQUESTS.get(cfg.name, 1),
             MOE_CPU_PROMPT.get(cfg.name, SP_CPU_PROMPT)) if moe
            else (1, SP_CPU_PROMPT))
    short = (media_batch(cpu_cfg, b, s, CPU_FRAMES, 7) if media
             else {"tokens": np.random.default_rng(7).integers(
                 0, cfg.vocab, (b, s), dtype=np.int32)})
    toks = twin.generate_batch(short, gen=SP_CPU_STEPS).tokens.cpu()
    if moe:
        held_check(twin, short, toks, label)
        return got, int4
    forced = stage_gaps(torch, A, twin, short, toks, SP_CPU_STEPS, label,
                        exact=("mm_proj", "logits"))[1]
    held_check(twin, short, toks, label, forced=forced)
    if not media:
        return got, int4
    # the VLM's twin unsharded (sp=1: an Engine), on the same request
    flat = ShardedEngine(twin.base_model, cpu_cfg, engine.policy, params,
                         twin.qparams, **{**kw, "sp": 1})
    cpu_check(torch, A, flat, short, flat.generate_batch(
        short, gen=SP_CPU_STEPS).tokens.cpu(), LOGIT_ATOL,
        f"{label} unsharded twin", n_check=SP_CPU_STEPS, logit_tol=tol)
    return got, int4


def rank_cache_hashes(torch, ST, A, engine, batch, tokens, rows=None):
    """sha-256 of each attention layer's K and V after the one-shot prefill
    of ``batch`` and after ``GEN`` - 1 decode steps fed ``tokens``: of the
    whole cache, or (``rows``, a rank count) of each rank's rows of it."""
    import hashlib

    def digest(cache):
        out = []
        for i in range(engine.cfg.n_layers):
            c = cache[f"layer{i}"]["attn"]
            for t in (c.k, c.v):
                parts = t.chunk(rows, dim=1) if rows else (t,)
                out.append([hashlib.sha256(p.contiguous().cpu().numpy()
                                           .tobytes()).hexdigest()
                            for p in parts])
        return out

    toks = torch.as_tensor(tokens).to(engine.device)
    b, s = batch["tokens"].shape
    with torch.inference_mode():
        cache = engine.init_cache(b, engine._cache_len(s, GEN))
        prefill = ST.make_prefill_step(engine.model, engine.policy,
                                       mode=engine.mode)
        _, cache = prefill(engine.serve_params, engine.qparams,
                           {"tokens": torch.as_tensor(batch["tokens"]).to(
                               engine.device)}, cache)
        first = digest(cache)
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        for i in range(GEN - 1):
            _, cache = engine.model.decode_step(
                engine.serve_params, toks[:, i:i + 1], cache, s + i, ctx)
    return first, digest(cache)


def rank_job(mesh, directory, cfg, shards, batch, trace_tokens):
    """One rank of [tp ranks] or [sp ranks] (``shards``: {"tp": n} or
    {"sp": n}): its engine restored from ``directory``, a warm-up call,
    then ``batch`` for 1 and for GEN tokens, the launch counts zeroed just
    before each; with ``trace_tokens``, its cache rows' hashes
    (``rank_cache_hashes``).  Returns every rank's report, gathered."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import api as A
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.shard import ShardedEngine

    eng = ShardedEngine.from_serving(directory, cfg, mesh=mesh, **shards)
    eng.generate_batch(batch, gen=2)

    def run(gen):
        ops.reset_launches()
        res = eng.generate_batch(batch, gen=gen)
        torch.cuda.synchronize()
        return res, dict(launches=ops.launch_counts(),
                         acc=ops.acc_launch_counts()["quant_matmul"],
                         **ops.reduce_counts(), **ops.gather_counts())

    _, pre = run(1)
    res, full = run(GEN)
    mine = dict(rank=mesh.rank, device=str(eng.device),
                eager=eng.eager_reason(), tokens=res.tokens.cpu(),
                prefill=res.prefill_logits.cpu(), pre=pre, full=full,
                prefill_s=res.prefill_s, decode_s=res.decode_s,
                int8_bytes=int8_bytes(torch, eng.serve_params))
    if trace_tokens is not None:
        mine["hashes"] = rank_cache_hashes(torch, ST, A, eng, batch,
                                           trace_tokens)
    # gloo alone: a host int32 payload of one decode reduce, no card work
    payload = torch.zeros(batch["tokens"].shape[0] * cfg.d_model,
                          dtype=torch.int32)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(GLOO_REPS):
        dist.all_reduce(payload)
    mine["gloo_ms"] = (time.perf_counter() - t0) / GLOO_REPS * 1e3
    everyone = [None] * mesh.n
    dist.all_gather_object(everyone, mine)
    return everyone


def drive_rank_phase(torch, ops, A, ST, sharded, batch, label, kind, card,
                     *, want=None, trace=False):
    """``sharded`` (a one-process ``ShardedEngine`` of tp or sp shards) as
    a rank mesh of as many processes (``rank_job``), over gloo on the one
    card.  Without ``want`` the one-process engine serves ``batch`` here
    first (a warm-up call, then GEN tokens, its launch counts zeroed just
    before); else ``want`` is its run's (result, launch counts).
    Checks: every rank's tokens and prefill logits bit for bit the
    one-process engine's, served uncaptured on its own card; a rank's
    launches of B3's int32-accumulator branch and of B4 the one-process
    run's over the ranks, its reduces and wire bytes the one-process
    run's; with ``trace``, each rank's cache rows after the prefill and
    after GEN - 1 steps those of the one-process cache.  Returns (the
    ranks' summed launch counts, summed int32-accumulator launches, rank
    0's reduce counts)."""
    from repro_torch.dist.ranks import run_ranks

    n = max(sharded.tp, sharded.sp)
    shards = {"tp": n} if sharded.tp > 1 else {"sp": n}
    if want is None:
        sharded.generate_batch(batch, gen=2)
        ops.reset_launches()
        res = sharded.generate_batch(batch, gen=GEN)
        want_counts = dict(launches=ops.launch_counts(),
                           acc=ops.acc_launch_counts()["quant_matmul"],
                           **ops.reduce_counts())
    else:
        res, launches = want
        want_counts = dict(launches=launches, acc=0)
    want_tokens = res.tokens.cpu()
    prefill_logits = res.prefill_logits.cpu()
    hashes = None
    if trace:
        hashes = rank_cache_hashes(torch, ST, A, sharded, batch,
                                   want_tokens, rows=n)
    whole = int8_bytes(torch, sharded.serve_params)
    cpu_batch = {k: np.asarray(torch.as_tensor(v).cpu())
                 for k, v in batch.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as wd:
        t0 = time.perf_counter()
        sharded.save_serving(wd)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(rank_job, n, backend="gloo", device="cuda",
                          threads=1, timeout=RANK_TIMEOUT_S, args=(wd, sharded.cfg, shards, cpu_batch,
                                want_tokens if trace else None))
        ranks_s = time.perf_counter() - t0
    print(f"[{label}] {sharded.cfg.name} ({sharded.cfg.n_layers} layers, "
          f"full width) on {n} ranks over gloo on one {kind} ({card}): "
          f"written in {save_s:.1f} s, {n} processes spawned, restored and "
          f"served in {ranks_s:.1f} s")
    for r in ranks:
        full, pre = r["full"], r["pre"]
        steps = GEN - 1
        dec = {k: (full[k] - pre[k]) / steps
               for k in ("acc", "reduces", "wire_bytes", "gathers",
                         "gather_bytes", "seconds")}
        dec_ms = r["decode_s"] / steps * 1e3
        print(f"[{label}] rank {r['rank']} on {r['device']}: resident int8 "
              f"weights {r['int8_bytes']} bytes ({r['int8_bytes'] / whole:.3f}"
              f" of the whole engine's {whole}); a decode step: "
              f"{dec['acc']:.0f} B3 int32-accumulator launches, "
              f"{dec['reduces']:.0f} reduces of {dec['wire_bytes']:.0f} int32 "
              f"wire bytes, {dec['gathers']:.0f} gathers of "
              f"{dec['gather_bytes']:.0f} bytes; decode {dec_ms:.2f} ms a "
              f"step, {dec['seconds'] * 1e3:.2f} ms of it "
              f"({dec['seconds'] * 1e3 / dec_ms:.1%}) in the collectives; "
              f"prefill {r['prefill_s'] * 1e3:.1f} ms ({pre['seconds'] * 1e3:.1f}"
              f" ms in collectives); a bare gloo all_reduce of one decode "
              f"reduce's host payload {r['gloo_ms']:.3f} ms; launches "
              f"{full['launches']}; int32-accumulator {full['acc']}")
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"rank {r['rank']} served on {r['device']}")
        if "uncaptured" not in (r["eager"] or ""):
            raise AssertionError(f"rank {r['rank']}: {r['eager']}")
        if not torch.equal(r["tokens"], want_tokens):
            raise AssertionError(f"rank {r['rank']}: tokens differ from the "
                                 "one-process engine's")
        if not torch.equal(r["prefill"], prefill_logits):
            raise AssertionError(f"rank {r['rank']}: prefill logits differ "
                                 "from the one-process engine's")
        one = want_counts
        checks = {"quant_matmul@acc": (full["acc"] * n, one["acc"]),
                  "reduces": (full["reduces"], one.get("reduces", 0)),
                  "wire_bytes": (full["wire_bytes"], one.get("wire_bytes",
                                                             0)),
                  "decode_attention_partials": (
                      full["launches"]["decode_attention_partials"] * n,
                      one["launches"]["decode_attention_partials"])}
        bad = {k: v for k, v in checks.items() if v[0] != v[1]}
        if bad:
            raise AssertionError(f"rank {r['rank']}: counts (rank x ranks "
                                 f"or rank, one process) differ: {bad}")
        if trace:
            for stage, (got, exp) in enumerate(zip(r["hashes"], hashes)):
                rows = [h[r["rank"]] for h in exp]
                if [h[0] for h in got] != rows:
                    raise AssertionError(
                        f"rank {r['rank']}: cache rows differ from the "
                        f"one-process cache's after "
                        f"{'the prefill' if stage == 0 else 'the last step'}")
    print(f"[{label}] every rank's {GEN} tokens and prefill logits "
          "bit-identical to the one-process engine's"
          + ("; every rank's cache rows bit-identical after the prefill and "
             f"after {GEN - 1} steps" if trace else ""))
    summed = {k: sum(r["full"]["launches"][k] for r in ranks)
              for k in ranks[0]["full"]["launches"]}
    return (summed, sum(r["full"]["acc"] for r in ranks),
            {k: ranks[0]["full"][k] for k in ("reduces", "wire_bytes")})


def tp_counts(ops):
    """(launch counts, B3 int32-accumulator launches, the reduces' count
    and wire bytes) since the last reset."""
    return (ops.launch_counts(), ops.acc_launch_counts()["quant_matmul"],
            ops.reduce_counts())


def drive_tp_phase(torch, ops, A, ShardedEngine, engine, batch, label, kind,
                   card, tp, walls=None, cpu=False, per_step=None):
    """The weights and thresholds of ``engine`` (a family's own phase: no
    new draw) as ``ShardedEngine(tp=tp)`` in the engine's cache layout:
    ``batch`` for GEN tokens through its captured programs (warm-up call
    first) and through the eager ``loop=True`` driver, the launch counts
    zeroed just before each and read just after.  Every row-parallel layer
    launches B3's int32-accumulator branch once per shard and reduces once;
    every other kernel runs as on the unsharded path, so the unsharded
    engine's B3 count, run on the same batch just before, is the tp run's
    B3 count plus its reduces (``per_step``: the reduces a decode step
    must take).  Checks: graphs == eager bit for bit; the tokens equal the
    unsharded engine's up to a near-tie (each unsharded token within
    ``LOGIT_ATOL`` of the tp engine's argmax, teacher-forced); with
    ``cpu``, the first request against the same tp engine on the CPU over
    4 teacher-forced steps (``cpu_check``); without, the prefill logits
    and tokens bit-identical to the unsharded engine's (the row epilogue
    rounds as the fused B3 does: int32 sums, the same float32 dequant and
    bf16 rounding), whose own path a depth-2 copy holds against the CPU.
    Prints prefill ms and tokens/s, decode ms a step, B3-int32 launches
    and the reduces' int32 wire bytes a decode step.  Returns (launch
    counts, int32-accumulator launches, reduce counts)."""
    cfg = engine.cfg
    base = getattr(engine, "base_model", engine.model)
    sharded = ShardedEngine(base, cfg, engine.policy, engine.serve_params,
                            engine.qparams, device=engine.device, tp=tp,
                            mode=engine.mode, cache_layout=engine.cache_layout)
    tokens = batch["tokens"]
    b, s = tokens.shape
    engine.generate_batch(batch, gen=2)     # the unsharded programs' capture
    ops.reset_launches()
    flat = engine.generate_batch(batch, gen=GEN)
    want = ops.launch_counts()
    warm = sharded.generate_batch(batch, gen=2)       # warm-up: the capture
    # the prefill's reduces alone (gen=1: no decode step), eagerly
    ops.reset_launches()
    sharded.generate_batch(batch, gen=1, loop=True)
    pre_red = ops.reduce_counts()

    def run(loop):
        ops.reset_launches()
        res = sharded.generate_batch(batch, gen=GEN, loop=loop)
        counts, acc, red = tp_counts(ops)
        driver = "loop=True" if loop else "graphs"
        print(f"[{label}] ({driver}) kernel launches {counts}; B3 int32-"
              f"accumulator launches {acc}; reduces {red}")
        exp = {**want, "quant_matmul": want["quant_matmul"] - red["reduces"]}
        if counts != exp or acc != tp * red["reduces"] or acc == 0:
            raise AssertionError(
                f"{driver}: launches {counts} (expected {exp}), int32 "
                f"partials {acc} (expected {tp} x {red['reduces']} reduces)")
        if per_step is not None and red["reduces"] != per_step * GEN:
            raise AssertionError(f"{driver}: {red['reduces']} reduces, "
                                 f"expected {per_step} x {GEN}")
        return res, counts, acc, red

    res, counts, acc, red = run(False)
    eager = run(True)[0]
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (b, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    if warm.compile_s <= 0.0 or res.compile_s != 0.0:
        raise AssertionError(f"compile_s {warm.compile_s} then "
                             f"{res.compile_s}: the first call must capture, "
                             "the second only replay")
    same = (torch.equal(res.prefill_logits, eager.prefill_logits)
            and torch.equal(res.tokens, eager.tokens))
    print(f"[{label}] graphs vs eager loop=True: prefill logits and {GEN} "
          f"greedy tokens {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("graphs and the eager driver disagree")
    decode_ms = res.decode_s / (GEN - 1) * 1e3
    n_pre = b * (s + (cfg.mm_patches if cfg.modality == "vlm" else 0))
    dec_red = (red["reduces"] - pre_red["reduces"]) // (GEN - 1)
    dec_bytes = (red["wire_bytes"] - pre_red["wire_bytes"]) // (GEN - 1)
    print(f"[{label}] {cfg.name} ({cfg.n_layers} layers, full width), tp="
          f"{tp}, int8 weights and KV cache, {engine.cache_layout} caches: "
          f"prefill {b} x {s}"
          + (f" + {batch['frames'].shape[1]} frames" if "frames" in batch
             else "")
          + f" {res.prefill_s * 1e3:.1f} ms = {n_pre / res.prefill_s:.0f} "
          f"positions/s; decode {decode_ms:.2f} ms per step of {b} "
          f"requests (graphs) on {kind} ({card}); eager loop=True prefill "
          f"{eager.prefill_s * 1e3:.1f} ms, decode "
          f"{eager.decode_s / (GEN - 1) * 1e3:.2f} ms per step; a decode "
          f"step: {dec_red * tp} B3 int32-accumulator launches, {dec_red} "
          f"reduces of {dec_bytes} int32 wire bytes (tp - 1 shards' "
          f"payload); the prefill's {pre_red['reduces']} reduces "
          f"{pre_red['wire_bytes']} bytes; graphs captured in "
          f"{warm.compile_s:.3f} s")
    if walls is not None:
        walls.setdefault(label, {}).update(
            graphs=(res.prefill_s * 1e3, decode_ms, warm.compile_s),
            eager=(eager.prefill_s * 1e3, eager.decode_s / (GEN - 1) * 1e3))
    ref_toks = flat.tokens
    n_same = int((toks == ref_toks.cpu()).sum())
    bitwise = n_same == toks.numel() and torch.equal(
        res.prefill_logits, flat.prefill_logits)
    gap = 0.0
    if n_same < toks.numel():
        lgs = forced_logits(torch, A, sharded, batch, ref_toks.cpu(), GEN)
        gap = max((lg.max(-1).values - lg.gather(
            1, ref_toks[:, i:i + 1].cpu())[:, 0]).max().item()
            for i, lg in enumerate(lgs))
    print(f"[{label}] tokens equal the unsharded engine's {n_same}/"
          f"{toks.numel()}" + (", prefill logits bit-identical" if bitwise
                              else "")
          + f"; teacher-forced on the unsharded tokens, the tp engine puts "
          f"them at most {gap:.4f} below its argmax (near-tie tolerance "
          f"{LOGIT_ATOL})")
    if not gap <= LOGIT_ATOL:
        raise AssertionError(f"unsharded tokens {gap} below the tp argmax")
    if cpu:
        cpu_check(torch, A, sharded, {k: v[:1] for k, v in batch.items()},
                  toks[:1], LOGIT_ATOL, f"{label} cpu check",
                  logit_tol=WIDE_LOGIT_ATOL.get(cfg.name, LOGIT_ATOL))
    elif not bitwise:
        # a wider config's unsharded path is held against the CPU by its
        # depth-2 copy ([<arch> cpu check]); its tp twin must equal it
        raise AssertionError("the tp engine's prefill logits or tokens "
                             "differ from the unsharded engine's")
    if walls is not None:
        replay_busy(torch, sharded, label, walls)
    return counts, acc, red


def check_tp_scheduler(torch, ops, A, ST, ShardedEngine, Request, engine,
                       kind, card):
    """The [scheduler]'s 16 ragged requests (prompts of 64-512 tokens, 32
    generated each) through 8 slots of ``engine``'s weights as
    ``ShardedEngine(tp=TP)`` over dense caches (the reference suite's
    layout), chunked prefill in chunks of CHUNK, through its captured
    admission and decode programs: every request finishes by its budget,
    every row-parallel layer launches the int32-accumulator branch once
    per shard, and the first 4 requests re-served alone through batch-1
    ``generate_batch`` give the same tokens or first differ at a near-tie.
    Returns (launch counts, int32-accumulator launches, reduce counts)."""
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab)
    base = getattr(engine, "base_model", engine.model)
    sharded = ShardedEngine(base, engine.cfg, engine.policy,
                            engine.serve_params, engine.qparams,
                            device=engine.device, tp=TP,
                            cache_layout="dense", prefill_chunk=CHUNK)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = sharded.generate(reqs, max_slots=SLOTS, block_steps=BLOCK_STEPS,
                            eos_id=-1)
    wall = time.perf_counter() - t0
    counts, acc, red = tp_counts(ops)
    sched = sharded._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    steps = calls["decode"] * BLOCK_STEPS
    serve = wall - sec["compile"]
    print(f"[tp scheduler] {len(done)} requests (prompts {lengths.min()}-"
          f"{lengths.max()} tokens, {GEN} generated each) through {SLOTS} "
          f"slots, tp={TP}, in {serve:.2f} s after the capture: "
          f"{len(done) / serve:.2f} requests/s, {len(done) * GEN / serve:.1f}"
          f" generated tokens/s; admission "
          f"{sec['admit'] / calls['prefill'] * 1e3:.1f} ms per request; "
          f"decode {sec['decode'] / steps * 1e3:.2f} ms per step on {kind} "
          f"({card}); programs captured in {sec['compile']:.3f} s; calls "
          f"{calls}; kernel launches {counts}; B3 int32-accumulator "
          f"launches {acc}; reduces {red}")
    bad = [(c.rid, c.status, c.finished_by, len(c.tokens)) for c in done
           if (c.status, c.finished_by, len(c.tokens)) != ("ok", "budget",
                                                           GEN)]
    if len(done) != len(reqs) or bad:
        raise AssertionError(f"{len(done)} completions; not ok/budget/{GEN}: "
                             f"{bad}")
    if sec["compile"] <= 0.0 or acc == 0 or acc != TP * red["reduces"]:
        raise AssertionError(f"capture {sec['compile']} s, {acc} int32 "
                             f"partials for {red['reduces']} reduces")
    by_rid = {c.rid: c for c in done}
    for r in range(4):
        got = by_rid[r].tokens
        alone = sharded.generate_batch({"tokens": reqs[r].tokens[None]},
                                       gen=GEN).tokens[0].tolist()
        if alone == got:
            print(f"[tp scheduler] request {r} ({lengths[r]} tokens) alone: "
                  f"{GEN} tokens equal")
            continue
        forced = teacher_forced_gap(torch, A, ST, sharded, reqs[r].tokens,
                                    got)
        if forced is None:
            raise AssertionError(
                f"request {r}: batch-1 generate_batch gives other tokens, "
                "but teacher-forced on the scheduler's tokens every argmax "
                "agrees")
        step, gap = forced
        print(f"[tp scheduler] request {r} ({lengths[r]} tokens) alone: "
              f"first differs at token {step}, where the batch-1 logits put "
              f"the scheduler's token {gap:.4f} below their argmax "
              f"(near-tie tolerance {LOGIT_ATOL})")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"request {r}: the scheduler's token {step} "
                                 f"is {gap} below the batch-1 argmax")
    return counts, acc, red


def print_entry_launches(label, name, ep):
    """One entry point's launch delta on the card beside its formula."""
    got = {f"{k}.{a}": n for (k, a), n in sorted(ep.launched.items())
           if a != "wire_bytes"}
    want = {f"{k}.{a}": n for (k, a), n in sorted(ep.expected.items())}
    print(f"[{label}] {name}: launches {got}"
          + ("" if got == want else f" != formula {want}"))


def check_analysis(torch, ops, ShardedEngine, engine, kind, card):
    """[analysis]: the analysis contracts on the card (see the module
    docstring, 26).  Returns the phase's seconds by step."""
    from repro_torch.analysis import entrypoints as EP
    from repro_torch.analysis.donation import check_no_fake_quant
    from repro_torch.analysis.record import Recorder
    from repro_torch.analysis.report import make_report
    from repro_torch.core import api as A

    secs = {}
    plain0 = ops.plain_call_count()
    t0 = time.perf_counter()
    eps = {}
    found, names = EP.run_analysis(device=engine.device, entry_points=eps)
    secs["sweep"] = time.perf_counter() - t0
    rep = make_report(found, entry_points=names,
                      backend=engine.device.type)
    print(f"[analysis] {kind} ({card}): analyzed {len(names)} entry points "
          f"(backend={rep['backend']}); {rep['counts']['error']} error(s), "
          f"{rep['counts']['warning']} warning(s) in {secs['sweep']:.1f} s")
    for f in found:
        print(f"[analysis]   {f.code} ({f.entry_point}) [{f.location}]: "
              f"{f.message}")
    for name, ep in eps.items():
        print_entry_launches("analysis", name, ep)
    if found or len(names) < 27:
        raise AssertionError(f"the sweep on the card: {len(found)} "
                             f"finding(s), {len(names)} entry points (27 on "
                             "the CPU)")
    bad = [n for n, ep in eps.items()
           if {k: v for k, v in ep.launched.items() if k[1] != "wire_bytes"}
           != ep.expected]
    if bad:
        raise AssertionError(f"launch deltas off their formulas: {bad}")

    # the full-width main engine's own prefill and decode
    t0 = time.perf_counter()
    own = {}
    found = engine.analyze()
    secs["Engine.analyze"] = time.perf_counter() - t0
    for name in ("prefill", "decode_loop"):
        own[name] = EP.engine_expected(engine, name,
                                       1 if name == "prefill" else 3)
    print(f"[analysis] Engine.analyze() on the [main path] engine "
          f"(smollm-135m, {engine.cfg.n_layers} layers, full width): "
          f"{len(found)} finding(s) in {secs['Engine.analyze']:.1f} s; "
          f"formulas {own}")
    for f in found:
        print(f"[analysis]   {f.code} ({f.entry_point}) [{f.location}]: "
              f"{f.message}")
    if found:
        raise AssertionError(f"Engine.analyze(): {len(found)} finding(s)")
    plain = ops.plain_call_count() - plain0
    print(f"[analysis] plain versions run on CUDA tensors: {plain}")
    if plain:
        raise AssertionError(f"{plain} plain version(s) ran on CUDA tensors")

    # the red case: fake-quant in a serving step, on the card
    t0 = time.perf_counter()
    fp = EP.build_engine(device=engine.device, fp=True)
    toks = EP.prompts(fp)
    ctx = A.make_ctx("fake", fp.policy, fp.qparams)
    with torch.no_grad(), Recorder() as rec:
        fp.model.hidden(fp.serve_params, {"tokens": toks}, ctx)
    fake = check_no_fake_quant(rec)
    dev = engine.device
    x = torch.randn(64, 576, device=dev)
    before = ops.launch_counts()["fake_quant"]
    with Recorder() as rec:
        ops.fake_quant(x, torch.ones(576, device=dev),
                       torch.full((576,), 0.9, device=dev))
    EP._sync(dev)
    b5 = ops.launch_counts()["fake_quant"] - before
    call = check_no_fake_quant(rec)
    secs["B5 red case"] = time.perf_counter() - t0
    print(f"[analysis] red case: a fake-mode forward gives "
          f"{sorted({f.code for f in fake})} via "
          f"{sorted(f.message.split('(via ')[1].split(')')[0] for f in fake)}"
          f"; ops.fake_quant gives {[f.code for f in call]}, B5 launched "
          f"{b5} time(s)")
    if not fake or {f.code for f in fake} != {"freeze.fake-quant-call"}:
        raise AssertionError(f"the fake-mode forward was not flagged: {fake}")
    if [f.code for f in call] != ["freeze.fake-quant-call"] or b5 < 1:
        raise AssertionError(f"ops.fake_quant: {call}, B5 launches {b5}")

    # the collective audit of the [tp path]'s shards
    t0 = time.perf_counter()
    tp = ShardedEngine(engine.model, engine.cfg, engine.policy,
                       engine.serve_params, engine.qparams,
                       device=engine.device, tp=TP,
                       cache_layout=engine.cache_layout)
    moved0 = ops.reduce_counts()["wire_bytes"]
    audit = tp.dry_run_report(batch=B)
    moved = ops.reduce_counts()["wire_bytes"] - moved0
    secs["dry_run_report tp"] = time.perf_counter() - t0
    dec, pre = audit["executables"]["decode"], audit["executables"]["prefill"]
    dtypes = sorted({d for ex in (pre, dec)
                     for d, _ in ex["all_reduce_payloads"]})
    print(f"[analysis] [tp path] dry_run_report(batch={B}): tp={TP}, "
          f"int8_all_reduces_ok={audit['int8_all_reduces_ok']}, payloads "
          f"{dtypes}; prefill {len(pre['all_reduce_payloads'])} all-reduces "
          f"of {pre['collective_bytes']} bytes, decode "
          f"{len(dec['all_reduce_payloads'])} of {dec['collective_bytes']} "
          f"bytes a step (want {TP_DECODE_WIRE_BYTES}); counted "
          f"{moved} ({card})")
    cfg = engine.cfg
    want = 2 * cfg.n_layers * B * cfg.d_model * 4 * (TP - 1)
    if not (audit["int8_all_reduces_ok"] and dtypes == ["int32"]
            and dec["collective_bytes"] == TP_DECODE_WIRE_BYTES == want
            and pre["collective_bytes"] + dec["collective_bytes"] == moved):
        raise AssertionError(f"[tp path] audit: {audit}")
    del tp
    return secs


def check_analysis_sp(torch, ops, engine_sp, card):
    """[analysis sp]: the [sp path] engine's collective audit: no
    all-reduce, its gathered partials' bytes the counted gathers'."""
    t0 = time.perf_counter()
    moved0 = ops.gather_counts()["gather_bytes"]
    audit = engine_sp.dry_run_report(batch=B)
    moved = ops.gather_counts()["gather_bytes"] - moved0
    dec, pre = audit["executables"]["decode"], audit["executables"]["prefill"]
    print(f"[analysis sp] [sp path] dry_run_report(batch={B}): sp="
          f"{engine_sp.sp}, int8_all_reduces_ok="
          f"{audit['int8_all_reduces_ok']}; all-reduces "
          f"{len(pre['all_reduce_payloads']) + len(dec['all_reduce_payloads'])}"
          f"; decode {dec['collective_by_kind']} bytes a step; counted "
          f"{moved}; {time.perf_counter() - t0:.1f} s ({card})")
    if not (audit["int8_all_reduces_ok"] and not pre["all_reduce_payloads"]
            and not dec["all_reduce_payloads"]
            and set(dec["collective_by_kind"]) == {"all-gather"}
            and pre["collective_bytes"] + dec["collective_bytes"] == moved):
        raise AssertionError(f"[sp path] audit: {audit}")
    return time.perf_counter() - t0


def check_prefix(torch, ops, Request, engine, kind, card):
    """4 requests with one 512-token prompt through the paged scheduler:
    one prefill, three prefix-store hits, every request the first's
    tokens.  Returns the launch counts."""
    prompt = np.random.default_rng(4).integers(0, engine.cfg.vocab, PROMPT,
                                               dtype=np.int32)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = engine.generate([Request(rid=r, tokens=prompt, max_gen=GEN)
                            for r in range(4)], max_slots=4,
                           block_steps=BLOCK_STEPS)
    wall = time.perf_counter() - t0
    sched = engine._scheduler
    calls, stats = sched.call_counts(), sched.prefix_stats()
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    toks = [c.tokens for c in sorted(done, key=lambda c: c.rid)]
    print(f"[prefix] 4 requests, one {PROMPT}-token prompt, in {wall:.2f} s "
          f"on {kind} ({card}): calls {calls}; prefix store {stats}; paged "
          f"launches {pg}; tokens equal to the first's "
          f"{sum(t == toks[0] for t in toks)}/4")
    if calls["prefill"] != 1 or stats["hits"] != 3:
        raise AssertionError(f"prefill calls {calls['prefill']}, hits "
                             f"{stats['hits']} (want 1 and 3)")
    if any(t != toks[0] for t in toks) or len(toks[0]) != GEN:
        raise AssertionError(f"prefix-shared requests differ: {toks}")
    return counts, pg


def calibrated(torch, A, ST, model, params, policy, batches):
    """§2 calibration over ``batches``, finalized with trainable
    thresholds (what the engine's fine-tune starts from)."""
    with torch.no_grad():
        qp = A.init_qparams(model, params, policy)
        calib = ST.make_calibrate_step(model, policy)
        for b in batches:
            qp = calib(params, qp, b)
        return A.finalize_calibration(qp, train_thresholds=True)


def inflate_kv(A, qparams, factor):
    """Every KV threshold ``factor`` times too wide, as one outlier in the
    calibration set makes it (the reference's over-calibration case,
    ``tests/test_threshold_train.py::_calibrate(inflate=)``)."""
    return {k: ({kk: {"t_max": st["t_max"] * factor,
                      "log2_t": st["log2_t"] + float(np.log2(factor))}
                 for kk, st in v.items()} if A.is_kv_path(k) else v)
            for k, v in qparams.items()}


def per_batch(losses, n):
    """(first-epoch, last-epoch) loss of each of the n batches."""
    return [(losses[b], losses[len(losses) - n + b]) for b in range(n)]


def check_finetune(torch, A, ST, engine, card):
    """The §3 fine-tune on the card.

    1. The int4 engine's own fine-tune (lr 1e-3, 2 epochs): every loss
       finite; the change of each batch's loss is printed.
    2. The over-calibration case the reference pins
       (``test_distill_loss_strictly_decreases``: KV thresholds 4x too
       wide, lr 0.1, cosine period 8), from the engine's weights and
       calibration, 2 epochs over the same batches on the card: each
       batch's loss must be lower in the last epoch than in the first.
    3. The first step of 1, from the same seeded inputs, on the card and
       on the CPU: the loss and the alpha and KV log2_t gradients."""
    from repro_torch import data as D
    from repro_torch.bridge import tree_to

    log = engine.finetune_log
    losses, step_s = log["losses"], log["step_s"]
    for i, (lo, sec) in enumerate(zip(losses, step_s)):
        print(f"[finetune] step {i}: loss {lo:.6f}  {sec * 1e3:.1f} ms "
              f"(synchronized)")
    batches = D.calibration_batches(engine.cfg.vocab, seed=0)
    n = len(batches)
    if not all(np.isfinite(losses)) or len(losses) % n:
        raise AssertionError(f"fine-tune losses {losses}")
    print(f"[finetune] {len(losses)} steps, {np.mean(step_s[1:]) * 1e3:.1f} "
          f"ms per step after the first ({step_s[0] * 1e3:.1f} ms) on {card}; "
          "loss per batch, first -> last epoch: " + ", ".join(
              f"{a:.4f} -> {b:.4f} ({(b - a) / a:+.2%})"
              for a, b in per_batch(losses, n)))

    dev = engine.device
    model, policy = engine.model, engine.policy
    params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)
    toks = [{"tokens": torch.as_tensor(b["tokens"], device=dev)}
            for b in batches]
    qp = calibrated(torch, A, ST, model, params, policy, toks)

    # 2. recovery from over-calibrated KV thresholds
    t0 = time.perf_counter()
    _, rec = ST.finetune_thresholds(
        model, policy, params, inflate_kv(A, qp, 4.0), toks, epochs=2,
        hp=ST.TrainHParams(base_lr=0.1, anneal_period=8))
    print(f"[finetune] KV thresholds 4x too wide, lr 0.1, 2 epochs in "
          f"{time.perf_counter() - t0:.1f} s: losses " + " ".join(
              f"{lo:.4f}" for lo in rec))
    for b, (first, last) in enumerate(per_batch(rec, n)):
        if not (np.isfinite(rec).all() and last < first):
            raise AssertionError(f"over-calibrated fine-tune, batch {b}: loss "
                                 f"{last} in the last epoch is not below "
                                 f"{first} in the first")

    # 3. the first step on the card and on the CPU
    grad_fn = ST.make_fat_grad_fn(model, policy)
    loss_g, grads_g = grad_fn(params, qp, toks[0])
    t0 = time.perf_counter()
    loss_c, grads_c = grad_fn(tree_to(params, "cpu"), tree_to(qp, "cpu"),
                              {"tokens": toks[0]["tokens"].cpu()})
    cpu_s = time.perf_counter() - t0
    loss_g, loss_c = float(loss_g), float(loss_c)
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    print(f"[finetune] first step: loss {loss_g:.6f} on the card (the "
          f"engine's: {losses[0]:.6f}), {loss_c:.6f} on the CPU ({cpu_s:.1f}"
          f" s); relative difference {rel_loss:.2e} (tolerance "
          f"{FT_LOSS_RTOL})")
    bad = [] if rel_loss <= FT_LOSS_RTOL else ["loss"]
    for kind, tol in FT_GRAD_RTOL.items():
        keys = [k for k in grads_c if k[-1] == kind]
        g = torch.cat([grads_g[k].float().cpu().reshape(-1) for k in keys])
        c = torch.cat([grads_c[k].float().reshape(-1) for k in keys])
        rel = ((g - c).norm() / c.norm()).item()
        agree = (torch.sign(g) == torch.sign(c)).float().mean().item()
        print(f"[finetune]   {kind} gradients ({len(keys)} leaves, "
              f"{c.numel()} values): relative L2 difference card vs CPU "
              f"{rel:.3e} (tolerance {tol}), signs agree {agree:.3f}, "
              f"|grad| max {c.abs().max().item():.3e}")
        if not rel <= tol:
            bad.append(f"{kind} gradients")
    if bad:
        raise AssertionError(f"first fine-tune step: {', '.join(bad)} differ "
                             "between card and CPU")


# -- slice 5: B5, B3 int4 weights, the training driver ----------------------

# fake-quant shapes: the fat_qat student's MLP and model widths at batch 8 x
# seq 128, benchmarks/run.py's shape, and a ragged one the TPU kernel
# refuses
FQ_SHAPES = ((1024, 1536), (1024, 576), (512, 256), (1000, 1000))
# GPU vs CPU alpha gradient of ops.fake_quant: the sum over rows runs in a
# fixed order of elementwise adds on both devices (ops._column_sum)
FQ_DALPHA_RTOL = 1e-5
# smollm-135m's matmul widths (K, N) for int4 weights
W4_WIDTHS = ((576, 1536), (1536, 576), (576, 192))
# B3 w4's rows: QMM_ROWS, then ragged rows (checked, not timed)
W4_ROWS = QMM_ROWS + (("ragged", 37),)
# resumed vs uninterrupted fat_qat thresholds on the card
RESUME_RTOL = 1e-5


def fq_inputs(torch, dev, gen, m, n, dtype, scalar_t=False):
    """x, t_max, alpha for B5: alphas below, on the ends of and above
    [0.5, 1]; columns 4..7 with s = 2 exactly and x * s on .5 ties."""
    x = torch.randn((m, n), generator=gen, device=dev) * 2
    t = torch.rand((n,), generator=gen, device=dev) * 2 + 0.5
    a = torch.rand((n,), generator=gen, device=dev) * 0.9 + 0.3
    a[:4] = torch.tensor([0.5, 1.0, 0.25, 1.5], device=dev)
    t[4:8], a[4:8] = 63.5, 1.0
    x[:, 4:8] = (torch.randint(-64, 64, (m, 4), generator=gen, device=dev)
                 + 0.5) / 2
    if scalar_t:
        t = torch.tensor(63.5, device=dev)
    return x.to(dtype), t, a


def check_fake_quant(torch, ops, ref, dev):
    """B5 against its plain version, bit for bit, at every shape and dtype,
    per-channel and scalar t_max and one alpha; timed beside the plain
    version and torch.fake_quantize_per_channel_affine.  Then the entry
    point's path: ``ops.fake_quant`` forward and STE backward at the
    student's shapes on the card, counted from 0, against the same
    autograd on the CPU.  Returns (JSON entries, launches)."""
    from repro_torch.kernels import fake_quant as fq

    gen = torch.Generator(device=dev).manual_seed(14)
    flush = l2_flush(torch, dev)
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for m, n in FQ_SHAPES:
            for scalar_t in (False, True):
                x, t, a = fq_inputs(torch, dev, gen, m, n, dtype, scalar_t)
                got, want = fq.launch(x, t, a), ref.fake_quant_ref(x, t, a)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)):
                    bad = int((got != want).sum())
                    raise AssertionError(
                        f"fake_quant {tag} ({m}, {n}) scalar_t={scalar_t}: "
                        f"{bad} elements differ from the plain version")
            one = torch.tensor(0.8, device=dev)
            if not torch.equal(fq.launch(x, t, one),
                               ref.fake_quant_ref(x, t, one)):
                raise AssertionError(f"fake_quant {tag} ({m}, {n}): one "
                                     "alpha differs from the plain version")
            x, t, a = fq_inputs(torch, dev, gen, m, n, dtype)
            ms, call = timed(torch, lambda: fq.launch(x, t, a))
            cold = cold_ms(torch, lambda: fq.launch(x, t, a), flush,
                           "fake_quant_kernel")
            plain, _ = timed(torch, lambda: ref.fake_quant_ref(x, t, a))
            t_adj = torch.clamp_min(torch.clamp(a, 0.5, 1.0) * t, 1e-8)
            inv = (t_adj / 127.0).float()
            zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
            try:
                lib, _ = timed(torch, lambda: torch.fake_quantize_per_channel_affine(
                    x, inv, zeros, 1, -127, 127))
                lib_note = "torch.fake_quantize_per_channel_affine"
            except RuntimeError as err:   # the yardstick may not take bf16
                lib, lib_note = None, f"none: {str(err).splitlines()[0]}"
            nbytes = 2 * m * n * x.element_size() + 8 * n
            bnd, by = bound_ms(nbytes, 8 * m * n, 67e12)
            print(f"  fake_quant {tag} ({m:4d}, {n:4d}): {ms * 1e3:7.1f} us "
                  f"warm, {cold * 1e3:7.1f} us L2-cold (per call "
                  f"{call * 1e3:6.1f} us)  plain "
                  f"{plain * 1e3:7.1f} us  bound {bnd * 1e3:6.2f} us  "
                  f"library {'-' if lib is None else f'{lib * 1e3:.1f} us'}"
                  f"  bit-identical (per-channel, scalar t, one alpha)")
            if (m, n) == FQ_SHAPES[0]:
                entries.append({
                    "name": f"fake_quant[{tag}, M={m}, N={n}: the fat_qat "
                            "student's MLP width at batch 8 x seq 128]",
                    "route": "cuda", "source": fq.SOURCE,
                    "replaces": fq.REPLACES, "kernel": "fake_quant",
                    "max_abs_err": 0.0, "ms": ms, "cold_ms": cold,
                    "call_ms": call, "plain_ms": plain, "bound_ms": bnd,
                    "bound_by": by,
                    "library_ms": lib, "library": lib_note})

    # the entry point's path: forward (the kernel) and STE backward
    ops.reset_launches()
    worst = 0.0
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m, n in FQ_SHAPES[:3]:
            x, t, a = fq_inputs(torch, dev, gen, m, n, dtype)
            w = torch.randn((m, n), generator=gen, device=dev)
            grads = []
            for d in (dev, torch.device("cpu")):
                xs, ts, as_ = (v.detach().to(d).requires_grad_(True)
                               for v in (x, t, a))
                y = ops.fake_quant(xs, ts, as_)
                torch.sum(y.float() * w.to(d)).backward()
                grads.append((xs.grad.cpu(), ts.grad.cpu(), as_.grad.cpu()))
            calls += 1
            (gx, gt, ga), (cx, ct, ca) = grads
            if not torch.equal(gx.view(torch.uint8), cx.view(torch.uint8)):
                raise AssertionError(f"fake_quant dx ({m}, {n}) differs "
                                     "between card and CPU")
            if gt.any() or ct.any():
                raise AssertionError("fake_quant's t_max gradient is not 0")
            rel = ((ga - ca).abs() / ca.abs().clamp_min(1e-30)).max().item()
            worst = max(worst, rel)
            if not torch.allclose(ga, ca, rtol=FQ_DALPHA_RTOL, atol=0):
                raise AssertionError(f"fake_quant dalpha ({m}, {n}): max "
                                     f"relative difference {rel}")
    launches = ops.launch_counts()["fake_quant"]
    print(f"  fake_quant path: ops.fake_quant forward + STE backward at "
          f"{[s for s in FQ_SHAPES[:3]]}, f32 and bf16: kernel launches "
          f"{launches} (expected {calls}); dx card vs CPU bit-identical, "
          f"dalpha max relative difference {worst:.2e} (tolerance "
          f"{FQ_DALPHA_RTOL}), dt_max 0")
    if launches != calls:
        raise AssertionError(f"fake_quant launches {launches} != {calls}")
    return entries, launches


def check_quant_matmul_w4(torch, ops, ref, dev):
    """B3 with int4 weights against its plain version and against the int8
    branch on the unpacked weights, bit for bit, at smollm-135m's widths;
    timed beside the int8 branch, the plain version and torch._int_mm on
    the unpacked weights.  Then the entry point's path,
    ``ops.quant_matmul(w_bits=4)`` at decode and prefill rows, counted
    from 0.  The decode rows are also timed L2-cold, as in
    ``check_quant_matmul``.  Returns (JSON entries, launches)."""
    from repro_torch.core.packing import pack_int4

    gen = torch.Generator(device=dev).manual_seed(15)
    flush = l2_flush(torch, dev)
    inputs = {}
    entries = []
    for phase, m in W4_ROWS:
        tot = dict(ms=0.0, call_ms=0.0, cold_ms=0.0, int8_ms=0.0,
                   plain_ms=0.0, bound_ms=0.0, library_ms=0.0, nbytes=0,
                   ops=0)
        for k, n in W4_WIDTHS:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            w_raw = torch.randint(-7, 8, (k, n), generator=gen, device=dev,
                                  dtype=torch.int8)
            w_q = pack_int4(w_raw, axis=0)
            w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-2
            act = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())
            inputs[(m, k, n)] = (x, w_q, w_scale, act)
            got = ops.quant_matmul(x, w_q, w_scale, act, w_bits=4)
            want = ref.quant_matmul_ref(x, w_q, w_scale, act, w_bits=4)
            int8 = ops.quant_matmul(x, w_raw, w_scale, act)
            torch.cuda.synchronize()
            for other, what in ((want, "its plain version"),
                                (int8, "the int8 branch on the unpacked "
                                       "weights")):
                if not torch.equal(got, other):
                    raise AssertionError(f"quant_matmul w_bits=4 (M={m}, "
                                         f"K={k}, N={n}) differs from {what}")
            if phase == "ragged":
                continue
            ms, call = timed(torch, lambda: ops.quant_matmul(
                x, w_q, w_scale, act, w_bits=4))
            cold = (cold_ms(torch, lambda: ops.quant_matmul(
                x, w_q, w_scale, act, w_bits=4), flush, "quant_matmul")
                if m <= DECODE_ROWS else None)
            i8, _ = timed(torch, lambda: ops.quant_matmul(x, w_raw, w_scale,
                                                          act))
            plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
                x, w_q, w_scale, act, 4), iters=5, warmup=1)
            x_q = torch.clamp(torch.round(x.float() * act), -127, 127).to(
                torch.int8)
            if m <= 16:
                x_q = torch.cat([x_q, x_q.new_zeros((32 - m, k))])
            lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_raw))
            nbytes = m * k * 2 + k * n // 2 + 4 * n + 4 + m * n * 2
            bnd, _ = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            print(f"  quant_matmul w_bits=4 M={m:5d} K={k:4d} N={n:4d}: "
                  f"{ms * 1e3:8.1f} us (per call {call * 1e3:6.1f} us"
                  + (f", L2-cold {cold * 1e3:.1f} us" if cold is not None
                     else "")
                  + ")  "
                  f"int8 branch {i8 * 1e3:8.1f} us  plain "
                  f"{plain * 1e3:9.1f} us  bound {bnd * 1e3:6.2f} us  "
                  f"_int_mm {lib * 1e3:.1f} us"
                  + (" (M padded to 32)" if m <= 16 else ""))
            for key, v in (("ms", ms), ("call_ms", call),
                           ("cold_ms", cold or 0.0), ("int8_ms", i8),
                           ("plain_ms", plain), ("bound_ms", bnd),
                           ("library_ms", lib), ("nbytes", nbytes),
                           ("ops", 2 * m * k * n)):
                tot[key] += v
        if phase == "ragged":
            print(f"  quant_matmul w_bits=4 M={m} (ragged): bit-identical at "
                  f"every width")
            continue
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        entries.append({
            "name": f"quant_matmul@w4[{phase}: smollm-135m's widths "
                    f"576x1536, 1536x576, 576x192, M={m}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": "quant_matmul@w4", "max_abs_err": 0.0,
            "ms": tot["ms"], "call_ms": tot["call_ms"],
            "int8_branch_ms": tot["int8_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"],
            "library": "torch._int_mm on the unpacked weights" + (
                f", x zero-padded from M={m} to M=32" if m <= 16 else ""),
            **({"cold_ms": tot["cold_ms"]} if m <= DECODE_ROWS else {})})

    ops.reset_launches()
    path_rows = (B, B * PROMPT)
    for m in path_rows:
        for k, n in W4_WIDTHS:
            ops.quant_matmul(*inputs[(m, k, n)], w_bits=4)
    torch.cuda.synchronize()
    launches = ops.w4_launch_counts()["quant_matmul"]
    expected = 2 * len(W4_WIDTHS)
    print(f"  quant_matmul w_bits=4 path: ops.quant_matmul(w_bits=4) at "
          f"M={path_rows} and every width: launches {launches} (expected "
          f"{expected})")
    if launches != expected:
        raise AssertionError(f"quant_matmul@w4 launches {launches}")
    return entries, launches


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def check_paper_tables(torch, ops, dev, card):
    """[paper tables]: ``python -m repro_torch.bench.run`` on the card at
    the reference's own sizes (Tables 1-2 on the reduced backbone, the
    §3.3/§4.2 DWS sequence, the §3.2 convergence, and ``kernels_micro``:
    B3 at 256x512x256 and B5 at 512x256, each bit for bit against its
    plain version before it is timed), with the paper's ordering asserts;
    prints the CSV rows and returns the run's launch counts (B5's only
    path)."""
    from repro_torch.bench import run as BR

    ops.reset_launches()
    rows = BR.run(dev)
    counts = ops.launch_counts()
    print(f"[paper tables] {card}: name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"[paper tables] {name},{us:.0f},{derived}")
    print(f"[paper tables] orderings held (scalar < rescaled, vector >= "
          f"scalar, loss40 < loss0, vector rmse <= scalar); launches "
          f"{counts}")
    if counts["quant_matmul"] == 0 or counts["fake_quant"] == 0:
        raise AssertionError(f"kernels_micro launched {counts}")
    return counts


def variants_pointwise(torch, A, ST, prepare_int8, model, policy, params,
                       calib, student_rmse):
    """The pointwise policy through the users' fine-tune,
    ``prepare_int8(finetune_epochs=1)``: one FAT step a calibration batch
    (``POINTWISE_STEPS``), the trained ``log2_t`` KV thresholds frozen
    back to ``t_max``.  Beside it, from the same calibration, the same
    steps at ``POINTWISE_LOW_LR`` through ``steps.finetune_thresholds``,
    and the untrained student.  Returns (the fine-tuned qparams, a note of
    the losses and the students' rmse)."""
    log: dict = {}
    _, qp = prepare_int8(model, policy, params, calib, convert=False,
                         finetune_epochs=1, finetune_log=log)
    with torch.no_grad():
        raw = A.init_qparams(model, params, policy)
        calib_step = ST.make_calibrate_step(model, policy)
        for b in calib:
            raw = calib_step(params, raw, b)
    low, low_losses = ST.finetune_thresholds(
        model, policy, params, A.finalize_calibration(
            raw, train_thresholds=True), calib, epochs=1,
        hp=ST.TrainHParams(base_lr=POINTWISE_LOW_LR))
    untrained = A.finalize_calibration(raw)
    rmse = {name: student_rmse(q) for name, q in (
        ("untrained", untrained), ("low", A.freeze_thresholds(low)))}
    pw = [e["w"]["pointwise"] for e in qp.values() if "w" in e]
    moved = sum(int((p != 1).sum()) for p in pw)
    kv = [(e[kk]["t_max"], untrained[path][kk]["t_max"])
          for path, e in qp.items() if A.is_kv_path(path) for kk in e]
    kv_moved = sum(int((t != t0).sum()) for t, t0 in kv)
    losses = log["losses"]
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)  # noqa: E731
    if (not all(np.isfinite(losses + low_losses)) or moved == 0
            or kv_moved == 0 or len(losses) != POINTWISE_STEPS
            or any("log2_t" in st for path, e in qp.items()
                   if A.is_kv_path(path) for st in e.values())):
        raise AssertionError(f"pointwise fine-tune: losses {losses} / "
                             f"{low_losses}, {moved} scales and {kv_moved} "
                             f"KV thresholds moved")
    return qp, (f"; prepare_int8's fine-tune ({POINTWISE_STEPS} FAT steps at "
                f"lr {ST.TrainHParams.base_lr}): losses {fmt(losses)}, "
                f"{moved} of {sum(p.numel() for p in pw)} pointwise scales "
                f"and {kv_moved} of {sum(t.numel() for t, _ in kv)} KV "
                f"thresholds moved; at lr {POINTWISE_LOW_LR}: losses "
                f"{fmt(low_losses)}, rmse {rmse['low']:.4f}; untrained "
                f"rmse {rmse['untrained']:.4f}")


# [dryrun]: two full-width cells on a 1 x 1 mesh, each sized on the meta
# device by ``repro_torch.launch.dryrun`` and then built and run on the
# card from the same functions (``dryrun.cell_inputs``): smollm-135m's
# one-shot prefill of 8 x 4096 tokens at full depth into a bf16 cache,
# granite-8b's decode step at full depth over a bf16 cache of 4 x 32768
DRYRUN_CELLS = (("smollm-135m", ("chip_prefill", "prefill", 4096, 8)),
                ("granite-8b", ("chip_decode", "decode", 32768, 4)))
DRYRUN_PEAK_RTOL = 0.10


def tree_nbytes(tree) -> int:
    """Sum of numel x element size over a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def drive_dryrun_phase(torch, ops, card):
    """[dryrun] (``DRYRUN_CELLS``): each cell's dry run on meta, then the
    same trees built on the card from a seeded CUDA generator and the
    same step run once, with the allocator's peak counted from the bytes
    held before the trees were built.  Checks: the predicted argument
    bytes are the real trees' (sum of numel x element size) exactly; the
    predicted peak is within ``DRYRUN_PEAK_RTOL`` of the measured one; the
    step launched B3 as many times as the meta trace called it (and, in
    the prefill cell, B2's bf16 variant, one a layer); the outputs are
    finite and the tokens inside the vocab.  Returns {cell: (launch
    counts, bf16 launch counts)}."""
    import gc

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core import api as A
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import build_model

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dryrun] predicted (meta trace, 1 x 1 mesh) against measured "
          f"on the card; {card}; total_memory {total} B "
          f"({total / 1e9:.2f} GB)")
    runs = {}
    for arch, spec in DRYRUN_CELLS:
        shape = ShapeSpec(*spec)
        t0 = time.perf_counter()
        rep = D.build_cell(arch, shape, mesh_shape=(1, 1), verbose=False)
        t_meta = time.perf_counter() - t0
        mem = rep["memory_analysis"]
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = build_model(get_config(arch))
        gen = torch.Generator("cuda").manual_seed(0)
        cell = D.cell_inputs(model, A.QuantPolicy(), shape,
                             SH.ShardingRules(), 1, gen)
        gc.collect()
        torch.cuda.synchronize()
        real_args = sum(tree_nbytes(tree) for tree, _ in cell.named.values())
        held = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t1 = time.perf_counter()
        out = cell.step(*cell.args)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - base
        counts = ops.launch_counts()
        bf16 = ops.bf16_launch_counts()
        logits = out[-2]
        finite = bool(torch.isfinite(logits.float()).all())
        tok_ok = True
        if shape.kind == "decode":
            tok_ok = bool(((out[0] >= 0) & (out[0] < model.cfg.vocab)).all())
        pred_peak = mem["peak_bytes_per_device"]
        gap = (pred_peak - peak) / peak
        calls = rep["kernel_calls"]
        print(f"[dryrun] {arch} x {shape.name} (B={shape.global_batch}, "
              f"S={shape.seq_len}, {model.cfg.n_layers} layers): meta trace "
              f"{t_meta:.2f} s, step on the card {t_step:.2f} s")
        print(f"  argument bytes: predicted {mem['argument_bytes']}, real "
              f"trees {real_args} (allocator {held})")
        print(f"  peak bytes: predicted {pred_peak} (arguments + "
              f"{mem['temp_bytes']} temp), measured {peak} "
              f"(max_memory_allocated less the {base} B held before), gap "
              f"{100 * gap:+.2f}%; of total_memory: predicted "
              f"{100 * pred_peak / total:.1f}%, measured "
              f"{100 * peak / total:.1f}%")
        print(f"  launches: B3 {counts['quant_matmul']} (meta calls "
              f"{calls.get('quant_matmul', 0)}), B2 "
              f"{counts['prefill_attention']} of which bf16 "
              f"{bf16['prefill_attention']} (meta calls "
              f"{calls.get('prefill_attention', 0)}), B1 "
              f"{counts['decode_attention']}")
        assert mem["argument_bytes"] == real_args, (
            f"{arch}: predicted argument bytes {mem['argument_bytes']} != "
            f"the real trees' {real_args}")
        assert abs(gap) <= DRYRUN_PEAK_RTOL, (
            f"{arch}: predicted peak {pred_peak} is {100 * gap:+.2f}% off "
            f"the measured {peak}")
        assert counts["quant_matmul"] == calls.get("quant_matmul") > 0, (
            f"{arch}: B3 launched {counts['quant_matmul']} times, the meta "
            f"trace called it {calls.get('quant_matmul')}")
        if shape.kind == "prefill":
            n = model.cfg.n_layers
            assert bf16["prefill_attention"] == counts[
                "prefill_attention"] == calls.get("prefill_attention") == n, (
                f"{arch}: B2 bf16 launches {bf16['prefill_attention']}, all "
                f"{counts['prefill_attention']}, meta calls "
                f"{calls.get('prefill_attention')}, layers {n}")
        assert finite and tok_ok, f"{arch}: non-finite logits or bad tokens"
        runs[f"dryrun {shape.name}"] = (counts, bf16)
        del cell, out, logits, model
        free_card(torch)
    return runs


def check_variants_full(torch, ops, A, ST, Engine, prepare_int8, build_model,
                        get_config, dev, kind, card):
    """[variants full]: smollm-135m at full width (d_model 576, seeded
    weights; ``SMOLLM_LAYERS`` of its 30 layers) through ``prepare_int8`` for each policy of
    ``VARIANT_POLICIES`` (int8 KV cache throughout; ``POINTWISE_STEPS``
    calibration batches; the pointwise scales fine-tuned as
    ``variants_pointwise`` says): the fake-mode student's rmse and top-1
    agreement against the bf16 teacher on 4 x ``VARIANT_PROMPT`` tokens,
    then the int8 form served (prefill + ``VARIANT_GEN`` greedy tokens
    through the captured programs), every quantized matmul through B3, and
    the tokens held against the same engine with the plain versions on the
    card (teacher-forced, up to a near-tie of ``LOGIT_ATOL``).  Returns
    B3's launches by policy."""
    from repro_torch import data as D
    from repro_torch.bridge import tree_to
    from repro_torch.core.distill import rmse_distill_loss

    cfg = get_config("smollm-135m").replace(n_layers=SMOLLM_LAYERS)
    model = build_model(cfg)
    params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)
    calib = [{"tokens": torch.as_tensor(b["tokens"], device=dev)}
             for b in D.calibration_batches(cfg.vocab, n=POINTWISE_STEPS)]
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (B, VARIANT_PROMPT), dtype=np.int32), device=dev)}
    prompts = rng.integers(0, cfg.vocab, (B, VARIANT_PROMPT), dtype=np.int32)
    with torch.no_grad():
        teacher = model(params, batch)
    launches = {}
    for name, kw in VARIANT_POLICIES.items():
        t0 = time.perf_counter()
        policy = A.QuantPolicy(kv_int8=True, **kw)

        @torch.no_grad()
        def student(qp):
            return model(params, batch, A.make_ctx("fake", policy, qp))

        note = ""
        if policy.pointwise_scales:
            qp, note = variants_pointwise(
                torch, A, ST, prepare_int8, model, policy, params, calib,
                lambda q: float(rmse_distill_loss(teacher, student(q))))
        else:
            _, qp = prepare_int8(model, policy, params, calib, convert=False)
        with torch.no_grad():
            logits = student(qp)
            rmse = float(rmse_distill_loss(teacher, logits))
            agree = float((teacher.argmax(-1) == logits.argmax(-1))
                          .float().mean())
            serve = A.convert_to_int8(model, params, qp, policy)
        del logits
        engine = Engine(model, cfg, policy, serve, qp, device=dev)
        engine.generate_batch({"tokens": prompts}, gen=2)       # capture
        ops.reset_launches()
        res = engine.generate_batch({"tokens": prompts}, gen=VARIANT_GEN)
        counts = ops.launch_counts()
        want = 7 * cfg.n_layers * VARIANT_GEN
        launches[name] = counts["quant_matmul"]
        toks = res.tokens.cpu()
        w_scale = serve["stack"]["layer0"]["attn"]["wq"]["w_scale"]
        print(f"[variants full] {name} ({kw or 'the default'}): fake-mode "
              f"rmse {rmse:.4f}, top-1 agreement {agree:.4f} with the bf16 "
              f"teacher on {B}x{VARIANT_PROMPT} tokens{note}; int8 serving "
              f"(w_scale shape {tuple(w_scale.shape)}): prefill "
              f"{res.prefill_s * 1e3:.2f} ms, decode "
              f"{res.decode_s / (VARIANT_GEN - 1) * 1e3:.3f} ms a step on "
              f"{kind} ({card}); launches {counts}")
        if counts["quant_matmul"] != want or not np.isfinite(rmse):
            raise AssertionError(f"{name}: quant_matmul launched "
                                 f"{counts['quant_matmul']} != {want}, rmse "
                                 f"{rmse}")
        if not bool(torch.isfinite(res.prefill_logits).all()):
            raise AssertionError(f"{name}: non-finite prefill logits")
        cpu_check(torch, A, engine, prompts, toks, LOGIT_ATOL,
                  f"variants full {name}", n_check=VARIANT_GEN,
                  plain_ops=ops)
        print(f"[variants full] {name}: {time.perf_counter() - t0:.1f} s")
        del engine, serve, qp
    return launches


def run_train(torch, train, argv, label):
    """``repro_torch.launch.train.main(argv)`` on the card; returns (its
    result, its printed losses by step, its ms per step after the first,
    the wall time, the peak device memory, the printed text)."""
    import contextlib
    import re

    tee = Tee(sys.stdout)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        print(f"[{label}] main({' '.join(argv)})")
        out = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = "".join(tee.text)
    losses = {int(s): float(v) for s, v in re.findall(
        r"^step\s+(\d+) loss (\S+)", text, re.M)}
    per = re.search(r"ms the first, ([\d.]+) ms each", text)
    return (out, losses, float(per.group(1)) if per else float("nan"),
            wall, torch.cuda.max_memory_allocated(), text)


def check_train_fat(torch, train, A, workdir, card):
    """[train fat_qat] at the full width of smollm-135m: 3 steps that
    checkpoint and stop, the same command to 6 steps (it must resume from
    step 3), and an uninterrupted 6-step run in a fresh directory; the
    resumed thresholds must equal the uninterrupted ones to RESUME_RTOL."""
    base = ["--arch", "smollm-135m", "--mode", "fat_qat",
            "--finetune-thresholds", "--batch", "8", "--seq", "128",
            "--calib-batches", "4", "--ckpt-every", "3", "--log-every", "1"]
    resumed = base + ["--ckpt-dir", os.path.join(workdir, "fat")]
    _, l1, ms1, w1, mem, _ = run_train(torch, train, resumed + ["--steps", "3"],
                                       "train fat_qat")
    (_, q_res), l2, ms2, w2, _, text = run_train(
        torch, train, resumed + ["--steps", "6"], "train fat_qat")
    if "[train] resuming from step 3" not in text or min(l2) != 3:
        raise AssertionError("the second run did not resume from step 3")
    (_, q_full), l3, ms3, w3, _, _ = run_train(
        torch, train, base + ["--ckpt-dir", os.path.join(workdir, "fat_full"),
                              "--steps", "6"], "train fat_qat")
    flat_r, flat_f = A.flatten(q_res), A.flatten(q_full)
    worst, same = 0.0, True
    for key, v in flat_f.items():
        r = flat_r[key]
        same &= torch.equal(r, v)
        d = ((r.float() - v.float()).abs()
             / v.float().abs().clamp_min(1e-30)).max().item()
        worst = max(worst, d)
    losses = {**l1, **l2}
    print(f"[train fat_qat] smollm-135m full width, batch 8 x seq 128, 4 "
          f"calibration batches, trained alphas and KV log2_t; losses "
          + " ".join(f"{losses[s]:.5f}" for s in sorted(losses))
          + f" (uninterrupted: " + " ".join(f"{l3[s]:.5f}" for s in
                                           sorted(l3))
          + f"); {ms3:.1f} ms per step after the first (runs: {ms1:.1f}, "
          f"{ms2:.1f}); wall per run {w1:.1f} / {w2:.1f} / {w3:.1f} s (init,"
          f" calibration, checkpoints included); peak device memory "
          f"{mem / 2**20:.1f} MiB on {card}")
    print(f"[train fat_qat] resumed vs uninterrupted thresholds: "
          f"{'bit-identical' if same else 'not bit-identical'}, max "
          f"relative difference {worst:.2e} (tolerance {RESUME_RTOL})")
    if not all(np.isfinite(list(losses.values()) + list(l3.values()))):
        raise AssertionError(f"non-finite fat_qat losses {losses} {l3}")
    if not worst <= RESUME_RTOL:
        raise AssertionError(f"resumed thresholds differ by {worst}")


def check_train_pretrain(torch, ops, A, train, Engine, CheckpointManager,
                         prompts, workdir, kind, card):
    """[train pretrain] at full width: 4 steps and one checkpoint; the loss
    must be finite and fall.  [checkpoint serve]: the int8 engine built
    from that checkpoint serves 4 x 512 prompts for 32 tokens through
    B1-B3, with the checkpoint's weights, and agrees with its CPU twin.
    Returns the served path's launch counts."""
    d = os.path.join(workdir, "pretrain")
    _, losses, ms, wall, mem, _ = run_train(
        torch, train, ["--arch", "smollm-135m", "--mode", "pretrain",
                       "--batch", "8", "--seq", "128", "--steps", "4",
                       "--ckpt-every", "4", "--log-every", "1",
                       "--ckpt-dir", d], "train pretrain")
    seq = [losses[s] for s in sorted(losses)]
    print(f"[train pretrain] smollm-135m full width, batch 8 x seq 128, lr "
          f"1e-3: losses " + " ".join(f"{v:.5f}" for v in seq)
          + f"; {ms:.1f} ms per step after the first; wall {wall:.1f} s; "
          f"peak device memory {mem / 2**20:.1f} MiB on {card}")
    if len(seq) != 4 or not np.isfinite(seq).all() or not seq[-1] < seq[0]:
        raise AssertionError(f"pretrain losses {seq} are not finite and "
                             "falling")

    t0 = time.perf_counter()
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    checkpoint_dir=d)
    torch.cuda.synchronize()
    print(f"[checkpoint serve] Engine.from_checkpoint(checkpoint_dir=...) "
          f"in {time.perf_counter() - t0:.1f} s")
    tree, meta = CheckpointManager(d).restore_latest()
    stored = A.flatten(tree["params"])
    served = A.flatten(engine.serve_params)
    kept = [k for k in stored if k in served]
    for key in kept:
        if not torch.equal(served[key].cpu(), stored[key]):
            raise AssertionError(f"served weight {key} is not the "
                                 "checkpoint's")
    print(f"[checkpoint serve] step {meta['step']}: the {len(kept)} "
          f"unquantized weight tensors (embedding, norms) are the "
          f"checkpoint's bits; {engine.n_int8_weights()} int8 weight tensors")
    res, counts, *_ = drive_main_path(torch, ops, engine, prompts,
                                      "checkpoint serve", kind, card, A=A)
    cpu_check(torch, A, engine, prompts, res.tokens.cpu(), LOGIT_ATOL,
              "checkpoint serve cpu check")
    return counts


def check_verify_attention(torch, ops, ref, dev, bits):
    """B2 at the speculative verify window of ``generate_batch`` (B = 4
    rows of SPEC_K + 1 queries, each row at its own q_start, over the main
    path's 640-position cache; one row inactive, kv_len 0) with a ``bits``
    K/V stream: against its plain version (``ATTN_TOL``, exact zeros for
    the inactive row), then timed warm and L2-cold beside the plain version
    and SDPA on the same window with an explicit mask.  Returns the JSON
    entry (kernel ``prefill_attention@verify`` at int8)."""
    import torch.nn.functional as F

    kvh, g, d, w = 3, 3, 64, SPEC_K + 1
    cap = -(-(PROMPT + GEN + SPEC_K) // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(31 + bits)
    k_scale, v_scale = kv_scales(torch, gen, dev, bits, kvh)
    k, v = (kv_stream(torch, gen, dev, (B, cap, kvh, d), bits)
            for _ in range(2))
    q = torch.randn((B, w, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    # mid-generation windows of the main path (prompts of 512), one idle
    qs = torch.tensor([PROMPT + 7, PROMPT + 20, PROMPT + 31, 0],
                      dtype=torch.int32, device=dev)
    kl = torch.tensor([PROMPT + 7 + w, PROMPT + 20 + w, PROMPT + 31 + w, 0],
                      dtype=torch.int32, device=dev)

    def kernel():
        return ops.prefill_attention(q, k, v, k_scale, v_scale, qs, kl,
                                     causal=True, kv_bits=bits)

    got = kernel()
    want = ref.prefill_attention_ref(q, k, v, k_scale, v_scale, qs, kl,
                                     causal=True, kv_bits=bits)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tag = f"{kv_kind(bits)} K/V"
    if not err <= ATTN_TOL * (1 + want.abs().max().item()):
        raise AssertionError(f"prefill_attention verify window ({tag}) "
                             f"disagrees with its plain version: {err}")
    if not torch.equal(got[3], torch.zeros_like(got[3])):
        raise AssertionError(f"prefill_attention verify window ({tag}): the "
                             "row with kv_len 0 is not exact zeros")
    ms, call = timed(torch, kernel)
    cold = cold_ms(torch, kernel, l2_flush(torch, dev),
                   "prefill_attention_kernel")
    plain, _ = timed(torch, lambda: ref.prefill_attention_ref(
        q, k, v, k_scale, v_scale, qs, kl, causal=True, kv_bits=bits))
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, w, d).contiguous()
    kh = dequant_heads(torch, k, k_scale, g, bits)
    vh = dequant_heads(torch, v, v_scale, g, bits)
    q_pos = qs[:, None] + torch.arange(w, device=dev)[None]
    mask = ((torch.arange(cap, device=dev)[None, None, :] <= q_pos[..., None])
            & (torch.arange(cap, device=dev)[None, None, :]
               < kl[:, None, None]))[:, None]
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    keys = int(kl.sum())
    pairs = sum(int(n) * w for n in kl)
    nbytes = (q.numel() * 2 + 2 * keys * kvh * d * bits // 8 + 8 * kvh
              + 8 * B + q.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * d * pairs * kvh * g, BF16_FLOPS_PER_S)
    print(f"  prefill_attention [verify window, {tag}] B={B} Sq={w} "
          f"q_start={qs.tolist()} cache={cap}: {ms * 1e3:.1f} us warm, "
          f"{cold * 1e3:.1f} us L2-cold (per call {call * 1e3:.1f} us)  "
          f"plain {plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"(explicit mask) {lib * 1e3:.1f} us  max|err| {err:.2e}; kv_len "
          "0 exact zeros")
    return {
        "name": f"prefill_attention[verify window: {tag}, B={B}, {w} "
                f"queries a row at its own q_start, cache {cap}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention@verify" + ("" if bits == 8 else "-int4"),
        "max_abs_err": err, "ms": ms, "cold_ms": cold, "call_ms": call,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib,
        "library": "SDPA on the dequantized bf16 cache, explicit mask"}


def sample_cpu_check(torch, A, SG, prng, engine, prompts, toks, label):
    """The sampled GPU tokens against the same engine moved to the CPU,
    teacher-forced on them with the same keys (``PRNGKey(seed)``, one split
    a token): each GPU token must be the CPU's sampled token, or the CPU's
    perturbed scores (logits / T + Gumbel noise) must put it within
    ``LOGIT_ATOL`` of the CPU's pick (a near-tie that rounding may
    flip)."""
    n_check = 4
    t0 = time.perf_counter()
    cpu = engine.to("cpu")
    tok_t = toks.cpu()
    lgs = forced_logits(torch, A, cpu, torch.as_tensor(prompts), tok_t,
                        n_check)
    temp, top_p = SAMPLING["temperature"], SAMPLING["top_p"]
    key = prng.PRNGKey(SAMPLING["seed"])
    same, ties, far = 0, 0, []
    for i, lg in enumerate(lgs):
        ks = prng.split(key)
        key, sub = ks[0], ks[1]
        pick = SG.sample_tokens(lg, sub, temperature=temp, top_p=top_p)
        pert = lg / temp + prng.gumbel(sub, lg.shape)
        for r in range(lg.shape[0]):
            g, c = int(tok_t[r, i]), int(pick[r])
            gap = (pert[r, c] - pert[r, g]).item()
            if g == c:
                same += 1
            elif gap <= LOGIT_ATOL:
                ties += 1
            else:
                far.append(f"step {i} row {r}: CPU samples {c}, GPU {g}, "
                           f"{gap:.4f} apart")
    print(f"[{label}] {n_check} teacher-forced steps on the CPU with the "
          f"same keys in {time.perf_counter() - t0:.1f} s: sampled tokens "
          f"equal {same}/{n_check * len(prompts)}, near-ties (perturbed gap "
          f"<= {LOGIT_ATOL}) {ties}, further apart {len(far)}")
    if far:
        raise AssertionError(f"sampled tokens differ: {far}")


def drive_sample_path(torch, ops, A, SG, prng, Engine, engine, prompts, kind,
                      card, walls, label="sample path", cpu=True):
    """[sample path]: the int8 main path sampled at ``SAMPLING`` (the
    reference's key schedule on the card): ``drive_main_path``'s launch
    counts and graphs == eager ``loop=True`` bit for bit, then the same
    seed again gives the same tokens, another seed other tokens, and (with
    ``cpu``) the GPU tokens pass the teacher-forced CPU check with the same
    keys.  Returns (result, launch counts)."""
    eng = Engine(engine.model, engine.cfg, engine.policy,
                 engine.serve_params, engine.qparams, device=engine.device,
                 mode=engine.mode, **SAMPLING)
    res, counts, *_ = drive_main_path(torch, ops, eng, prompts,
                                      label, kind, card,
                                      walls=walls, A=A)
    again = eng.generate_batch({"tokens": prompts}, gen=GEN)
    other = Engine(engine.model, engine.cfg, engine.policy,
                   engine.serve_params, engine.qparams, device=engine.device,
                   mode=engine.mode, **{**SAMPLING, "seed": SAMPLING["seed"]
                                        + 1}).generate_batch(
        {"tokens": prompts}, gen=GEN)
    n_same = int((other.tokens == res.tokens).sum())
    print(f"[{label}] {SAMPLING}: the same seed again gives the same "
          f"{GEN} tokens: {torch.equal(again.tokens, res.tokens)}; seed "
          f"{SAMPLING['seed'] + 1} agrees on {n_same}/{res.tokens.numel()} "
          f"tokens; decode {res.decode_s / (GEN - 1) * 1e3:.3f} ms per "
          f"sampled step (graphs) on {kind} ({card})")
    if not torch.equal(again.tokens, res.tokens):
        raise AssertionError("the same seed gave other tokens")
    if n_same == res.tokens.numel():
        raise AssertionError("another seed gave the same tokens")
    if cpu:
        sample_cpu_check(torch, A, SG, prng, eng, prompts, res.tokens,
                         "sample cpu check")
    return res, counts


def spec_eager(torch, ST, SG, prng, eng, prompts):
    """The speculative engine's prefill and GEN - 1 verify windows run
    eagerly on the card (the steps its programs capture, uncaptured), with
    the windows' counters: (tokens (B, GEN), stats)."""
    dev = eng.device
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=dev).long()
        b, s = toks.shape
        cache_len = eng._cache_len(s, GEN + SPEC_K)
        cache = eng.init_cache(b, cache_len)
        prefill = ST.make_prefill_step(eng.model, eng.policy,
                                       prefill_chunk=eng.prefill_chunk,
                                       mode=eng.mode)
        if eng.prefill_chunk:
            padded, lengths = ST.pad_for_chunked_prefill(toks,
                                                         eng.prefill_chunk)
            logits, cache = prefill(eng.serve_params, eng.qparams,
                                    {"tokens": padded}, cache, lengths)
        else:
            logits, cache = prefill(eng.serve_params, eng.qparams,
                                    {"tokens": toks}, cache)
        tok0 = logits[:, -1].argmax(-1)
        st = SG.WindowState(
            tok=torch.empty_like(tok0),
            pos=torch.empty((b,), dtype=torch.int32, device=dev),
            n_out=torch.empty((b,), dtype=torch.int32, device=dev),
            out=torch.empty((b, GEN), dtype=torch.long, device=dev),
            key=prng.PRNGKey(0, dev),
            hist=torch.zeros((b, cache_len), dtype=torch.long,
                             device=dev)).start(tok0, s)
        SG.seed_hist(st.hist, toks, tok0)
        step = SG.make_window_step(eng._strategy, GEN)
        live = row_windows = emitted = 0
        for _ in range(GEN - 1):
            before = st.n_out.clone()
            step(eng.serve_params, eng.qparams, st, cache)
            rows = before < GEN
            live += int(rows.any())
            row_windows += int(rows.sum())
            emitted += int((torch.clamp(st.n_out, max=GEN) - before)[
                rows].sum())
    tpw = emitted / max(row_windows, 1)
    return st.out, {"windows": GEN - 1, "windows_live": live,
                    "row_windows": row_windows, "tokens": emitted,
                    "tokens_per_window": tpw,
                    "acceptance_rate": max(tpw - 1.0, 0.0) / SPEC_K}


def drive_spec_path(torch, ops, A, ST, SG, prng, Engine, engine, prompts,
                    greedy, label, kind, card, page=None, walls=None):
    """4 x 512 prompts for 32 tokens with speculative decoding (``SPEC_K``
    drafts from ``SPEC_NGRAM``-gram prompt lookup, each verify window
    through B2 at per-row q_start) on ``engine``'s weights, dense or (pages
    of ``page``, chunks of CHUNK) paged: every window's attention through
    B2 and none through B1, the captured programs bit-identical to the same
    steps run eagerly, and the tokens equal to the card's greedy tokens
    ``greedy`` or, where they part, each within ``LOGIT_ATOL`` of the
    argmax of the eager greedy steps teacher-forced on them (B2 and B1 sum
    in other orders).  Returns (launch counts, B2 launches of the verify
    windows)."""
    kw = dict(SPECULATIVE)
    if page:
        kw.update(cache_layout="paged", page_size=page, prefill_chunk=CHUNK)
    eng = Engine(engine.model, engine.cfg, engine.policy,
                 engine.serve_params, engine.qparams, device=engine.device,
                 mode=engine.mode, **kw)
    warm = eng.generate_batch({"tokens": prompts}, gen=GEN)    # captures
    ops.reset_launches()
    res = eng.generate_batch({"tokens": prompts}, gen=GEN)
    counts, pg, int4 = (ops.launch_counts(), ops.paged_launch_counts(),
                        ops.int4_launch_counts())
    n, chunks = engine.cfg.n_layers, (PROMPT // CHUNK if page else 1)
    verify = n * (GEN - 1)
    expected = {"quant_matmul": 7 * n * (chunks + GEN - 1),
                "prefill_attention": n * chunks + verify,
                "decode_attention": 0, "decode_attention_partials": 0,
                "fake_quant": 0}
    attn = {k: expected[k] for k in ops.ATTENTION}
    pg_expected = attn if page else {k: 0 for k in attn}
    int4_expected = (attn if engine.policy.kv_bits == 4
                     else {k: 0 for k in attn})
    print(f"[{label}] kernel launches {counts} (expected {expected}); paged "
          f"{pg}; int4 {int4}; {verify} of B2's in the {GEN - 1} verify "
          "windows")
    if (counts, pg, int4) != (expected, pg_expected, int4_expected):
        raise AssertionError(f"launch counts {counts} / {pg} / {int4}")
    if warm.compile_s <= 0.0 or res.compile_s != 0.0:
        raise AssertionError(f"compile_s {warm.compile_s} then "
                             f"{res.compile_s}")
    t0 = time.perf_counter()
    eager, stats = spec_eager(torch, ST, SG, prng, eng, prompts)
    eager_s = time.perf_counter() - t0
    if not torch.equal(eager, res.tokens):
        raise AssertionError(
            f"speculative graphs and the eager steps disagree: "
            f"{int((eager == res.tokens).sum())}/{eager.numel()} tokens "
            "equal")
    same = int((res.tokens == greedy).sum())
    gap = 0.0 if same == greedy.numel() else forced_gap(
        torch, A, eng, prompts, res.tokens)
    print(f"[{label}] graphs == eager steps bit for bit; tokens equal the "
          f"same engine's greedy tokens {same}/{greedy.numel()} (teacher-"
          f"forced gap "
          f"of the speculative tokens {gap:.4f}, near-tie tolerance "
          f"{LOGIT_ATOL}); windows {stats['windows']}, with a live row "
          f"{stats['windows_live']}; {stats['tokens_per_window']:.3f} tokens "
          f"per row window, acceptance {stats['acceptance_rate']:.3f}; "
          f"prefill {res.prefill_s * 1e3:.2f} ms, "
          f"{res.decode_s / (GEN - 1) * 1e3:.3f} ms per verify window "
          f"(graphs), eager {eager_s:.2f} s for prefill + windows; captured "
          f"in {warm.compile_s:.3f} s on {kind} ({card})")
    if not gap <= LOGIT_ATOL:
        raise AssertionError(f"speculative tokens {gap} below the greedy "
                             "argmax")
    if walls is not None:
        walls[label + " (ms per window)"] = {
            "graphs": (res.prefill_s * 1e3, res.decode_s / (GEN - 1) * 1e3,
                       warm.compile_s)}
    return counts, verify


def teacher_forced_sample_gap(torch, A, ST, SG, prng, engine, prompt, tokens,
                              rid):
    """Batch-1 chunked prefill + decode of ``prompt`` fed ``tokens``, each
    step sampled with request ``rid``'s keys (``fold_in(PRNGKey(seed),
    rid)``, split into the first token's key and the carried key): the
    first step whose sampled token is not ``tokens[step]``, with the gap of
    the perturbed scores (logits / T + Gumbel noise) between the two; None
    when every step agrees."""
    dev = engine.device
    temp, top_p = SAMPLING["temperature"], SAMPLING["top_p"]
    with torch.inference_mode():
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        toks = torch.as_tensor(prompt, device=dev)[None]
        cache = engine.init_cache(1, engine._cache_len(toks.shape[1],
                                                       len(tokens)))
        padded, lengths = ST.pad_for_chunked_prefill(toks, CHUNK)
        logits, cache = ST.make_prefill_step(
            engine.model, engine.policy, prefill_chunk=CHUNK,
            mode=engine.mode)(engine.serve_params, engine.qparams,
                              {"tokens": padded}, cache, lengths)
        ks = prng.split(prng.fold_in(prng.PRNGKey(SAMPLING["seed"]), rid))
        key, carry = ks[0].to(dev), ks[1].to(dev)
        for i, t in enumerate(tokens):
            row = logits[0, -1:].float()
            pick = int(SG.sample_tokens(row, key, temperature=temp,
                                        top_p=top_p)[0])
            if pick != t:
                pert = row[0] / temp + prng.gumbel(key, row.shape)[0]
                return i, (pert[pick] - pert[t]).item()
            logits, cache = engine.model.decode_step(
                engine.serve_params, torch.tensor([[t]], device=dev), cache,
                toks.shape[1] + i, ctx)
            ks = prng.split(carry)
            key, carry = ks[0], ks[1]
    return None


def check_strategy_scheduler(torch, ops, A, ST, SG, prng, Engine, Request,
                             engine, kind, card, scheme, n_alone=4):
    """[speculative scheduler] / [sampled scheduler]: N_REQUESTS ragged
    requests (64-512 tokens, GEN generated each) through SLOTS slots of
    ``engine``'s paged cache, speculative (each slot's verify windows
    through B2's paged variant, none through B1) or sampled (per-request
    keys).  Every request finishes by its budget; ``n_alone`` of them
    served alone agree: speculative, with batch-1 greedy ``generate_batch``
    (equal or a near-tie, ``teacher_forced_gap``); sampled, with batch-1
    steps teacher-forced on them with the request's keys (equal or a
    near-tie of the perturbed scores).  Sampled completions must not depend
    on the arrival order: the requests again, reversed, give the same
    tokens.  Returns (launch counts, paged launch counts, the
    completions)."""
    from repro_torch.launch.graphs import WARMUP

    label = f"{'speculative' if scheme == 'speculative' else 'sampled'} " \
            "scheduler"
    eng = Engine(engine.model, engine.cfg, engine.policy,
                 engine.serve_params, engine.qparams, device=engine.device,
                 mode=engine.mode, cache_layout="paged", page_size=PAGE,
                 prefill_chunk=CHUNK,
                 **(SPECULATIVE if scheme == "speculative" else SAMPLING))
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.generate(reqs, max_slots=SLOTS, block_steps=BLOCK_STEPS)
    wall = time.perf_counter() - t0
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    sched = eng._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    n = engine.cfg.n_layers
    steps = calls["decode"] * BLOCK_STEPS
    # every step of a block (and of the capture's warm-up blocks) runs one
    # decode or verify pass a layer
    passes = n * (steps + WARMUP * BLOCK_STEPS)
    want_pg = {"prefill_attention": passes if scheme == "speculative" else 0,
               "decode_attention": 0 if scheme == "speculative" else passes,
               "decode_attention_partials": 0}
    serve = wall - sec["compile"]
    print(f"[{label}] {len(done)} requests through {SLOTS} slots in "
          f"{serve:.2f} s after a {sec['compile']:.2f} s capture: "
          f"{len(done) / serve:.2f} requests/s, "
          f"{len(done) * GEN / serve:.1f} tokens/s; admission "
          f"{sec['admit'] / max(calls['prefill'], 1) * 1e3:.1f} ms per "
          f"prefill, {sec['decode'] / calls['decode'] * 1e3:.1f} ms per block "
          f"of {BLOCK_STEPS} steps on {kind} ({card}); calls {calls}; "
          f"launches {counts}; paged {pg} (expected {want_pg}); spec_stats "
          f"{sched.spec_stats()}")
    bad = [(c.rid, c.status, c.finished_by, len(c.tokens)) for c in done
           if (c.status, c.finished_by, len(c.tokens)) != ("ok", "budget",
                                                           GEN)]
    if len(done) != N_REQUESTS or bad:
        raise AssertionError(f"{len(done)} completions; not ok/budget/{GEN}: "
                             f"{bad}")
    if pg != want_pg:
        raise AssertionError(f"paged launches {pg}, expected {want_pg}")
    by_rid = {c.rid: c.tokens for c in done}
    if scheme == "sample":
        again = {c.rid: c.tokens for c in eng.generate(
            reqs[::-1], max_slots=SLOTS, block_steps=BLOCK_STEPS)}
        moved = [r for r in by_rid if again[r] != by_rid[r]]
        print(f"[{label}] the requests again in reverse arrival order: "
              f"{N_REQUESTS - len(moved)}/{N_REQUESTS} streams equal")
        if moved:
            raise AssertionError(f"sampled streams depend on arrival order: "
                                 f"requests {moved}")
    dense = layout_twin(Engine, eng, "dense")
    for r in range(n_alone):
        got = by_rid[r]
        if scheme == "sample":
            forced = teacher_forced_sample_gap(torch, A, ST, SG, prng, dense,
                                               reqs[r].tokens, got, r)
        else:
            alone = dense.generate_batch({"tokens": reqs[r].tokens[None]},
                                         gen=GEN).tokens[0].tolist()
            forced = None if alone == got else teacher_forced_gap(
                torch, A, ST, dense, reqs[r].tokens, got)
        if forced is None:
            print(f"[{label}] request {r} ({lengths[r]} tokens) alone: "
                  f"{GEN} tokens agree")
            continue
        step, gap = forced
        print(f"[{label}] request {r} alone: first differs at token {step}, "
              f"{gap:.4f} apart (near-tie tolerance {LOGIT_ATOL})")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"request {r}: token {step} is {gap} apart")
    return counts, pg, done


def recovery_engine(Engine, engine, layout="paged", **kw):
    """The [scheduler] engine's weights and thresholds in ``layout`` (pages
    of PAGE, chunks of CHUNK), with the resilience and durability knobs
    ``kw``."""
    return Engine(engine.model, engine.cfg, engine.policy,
                  engine.serve_params, engine.qparams, device=engine.device,
                  mode=engine.mode, cache_layout=layout, page_size=PAGE,
                  prefill_chunk=CHUNK, **kw)


def near_tie(torch, A, ST, SG, prng, dense, req, got, want, label,
             sampled=False):
    """True when ``got`` equals ``want`` bit for bit; else the batch-1
    engine ``dense``, teacher-forced on ``got`` (sampled: with the request's
    keys, on the perturbed scores), must find it within LOGIT_ATOL of its
    own choice at the first step that differs, and False is returned."""
    if got == want:
        return True
    if sampled:
        forced = teacher_forced_sample_gap(torch, A, ST, SG, prng, dense,
                                           req.tokens, got, req.rid)
    else:
        forced = teacher_forced_gap(torch, A, ST, dense, req.tokens, got)
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
        if len(got) == len(want) else min(len(got), len(want))
    if forced is None:
        print(f"[{label}] request {req.rid}: first differs from the clean "
              f"run at token {first}; batch-1 teacher-forced on it agrees "
              "at every step")
        return False
    step, gap = forced
    print(f"[{label}] request {req.rid}: first differs from the clean run at "
          f"token {first}; batch-1 teacher-forced on it puts token {step} "
          f"{gap:.4f} from its own choice (near-tie tolerance {LOGIT_ATOL})")
    if not gap <= LOGIT_ATOL:
        raise AssertionError(f"request {req.rid}: token {step} is {gap} "
                             "apart")
    return False


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def check_resilience(torch, ops, A, ST, SG, prng, Engine, Request, FaultPlan,
                     engine, kind, card, layout, clean):
    """[resilience dense] / [resilience paged]: the [scheduler]'s 16
    requests through SLOTS slots under ``RESILIENCE_PLAN`` (paged also
    exhausting the prefix pool), with ``queue_cap`` RESILIENCE_QUEUE_CAP
    and the virtual clock.  Every request retires with the status the plan
    implies, ``health_stats()`` holds the plan's counts, the requests the
    plan never parked give the clean [scheduler] run's tokens (``clean``)
    bit for bit, the two parked ones equal them up to a near-tie; the
    admission prefill and the decode block are captured once, the
    ``resume`` prefill once, and its replay launches B2 and B3.  Returns
    (launch counts, paged launch counts, the resume replay's numbers)."""
    label = f"resilience {layout}"
    plan = FaultPlan(**RESILIENCE_PLAN, exhaust_prefix=layout == "paged")
    eng = recovery_engine(Engine, engine, layout,
                          queue_cap=RESILIENCE_QUEUE_CAP, fault_plan=plan)
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab,
                                       extra=RESILIENCE_EXTRA)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.generate(reqs, max_slots=SLOTS, block_steps=BLOCK_STEPS)
    wall = time.perf_counter() - t0
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    sched = eng._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    health, built = sched.health_stats(), sched.executable_counts()
    by_rid = {c.rid: c for c in done}
    print(f"[{label}] plan: {plan.describe()}; queue_cap "
          f"{RESILIENCE_QUEUE_CAP}; {len(done)} requests in {wall:.2f} s "
          f"({sec['compile']:.2f} s of captures) on {kind} ({card})")
    print(f"[{label}] statuses "
          f"{ {r: (c.status, len(c.tokens)) for r, c in sorted(by_rid.items())} }")
    print(f"[{label}] health {health}; calls {calls}; programs built "
          f"{built}; launches {counts}; paged {pg}")
    want = {r: RESILIENCE_STATUS.get(r, "ok") for r in range(N_REQUESTS)}
    got = {r: c.status for r, c in by_rid.items()}
    if got != want:
        raise AssertionError(f"statuses {got}, the plan implies {want}")
    want_health = dict(RESILIENCE_HEALTH, prefix_exhausted=(
        RESILIENCE_HEALTH["prefix_exhausted"] if layout == "paged" else 0))
    bad = {k: (health[k], v) for k, v in want_health.items()
           if health[k] != v}
    if bad:
        raise AssertionError(f"health (got, want): {bad}")
    if len(by_rid[3].tokens) != 1 + RESILIENCE_PLAN["nan_decode"][0][1]:
        raise AssertionError(f"request 3 froze after "
                             f"{len(by_rid[3].tokens)} tokens")
    if built != {"prefill": 1, "decode": 1, "resume": 1}:
        raise AssertionError(f"programs built {built}")
    if any(p.graph is None for p in (sched._admission, sched._block,
                                     sched._resume)):
        raise AssertionError("a scheduler program was not captured")
    dense = layout_twin(Engine, engine, "dense")
    exact = []
    for r, c in sorted(by_rid.items()):
        if c.status != "ok":
            continue
        if r not in RESILIENCE_PARKED and c.tokens != clean[r]:
            raise AssertionError(f"request {r} was never parked but differs "
                                 f"from the clean [scheduler] run")
        if near_tie(torch, A, ST, SG, prng, dense, reqs[r], c.tokens,
                    clean[r], label):
            exact.append(r)
    parked_exact = [r for r in RESILIENCE_PARKED if r in exact]
    print(f"[{label}] {len(exact)} of {len(by_rid) - len(RESILIENCE_STATUS)}"
          f" ok requests bit-identical to the clean [scheduler] run; "
          f"re-admitted through resume: {list(RESILIENCE_PARKED)}, "
          f"bit-identical {parked_exact}")
    res = sched._resume
    # a replay's launches by (kernel, counter): each kernel's total
    launches = {name: n for (name, attr), n in res.launches.items()
                if attr == "launches"}
    if not (launches.get("prefill_attention") and
            launches.get("quant_matmul")):
        raise AssertionError(f"one resume replay launches {launches}: no B2 "
                             "or no B3")
    busy = program_busy(torch, res)
    wall_ms = sec["resume"] / calls["resume"] * 1e3
    print(f"[{label}] resume prefill at resume_cap {sched.resume_cap} "
          f"({sched.resume_cap // CHUNK} chunks of {CHUNK}): "
          f"{calls['resume']} re-admissions, {wall_ms:.2f} ms wall each "
          f"(replay + splice, synchronized); device busy per replay "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'} "
          f"(torch.profiler); one replay launches {launches}, captured in "
          f"the run's compile seconds; on {kind} ({card})")
    return counts, pg, {"resume_wall_ms": wall_ms, "resume_busy_ms": busy,
                        "resume_launches": launches}


def check_recovery_journal(torch, ops, A, ST, SG, prng, Engine, Request,
                           FaultPlan, SimulatedCrash, RequestJournal, engine,
                           kind, card, clean, clean_sampled, workdir):
    """[recovery journal]: the [scheduler]'s 16 requests, journaled, crash
    at block boundary 2; ``recover()`` on a fresh engine's scheduler, once
    greedy (against ``clean``) and once sampled with ``SAMPLING`` (against
    the [sampled scheduler] run, ``clean_sampled``).  The requests in
    flight at the crash rebuild through the ``resume`` prefill and equal
    the clean run up to a near-tie (sampled: of the perturbed scores); the
    queued ones bit for bit.  Returns (launch counts, paged launch
    counts)."""
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab)
    sched_kw = dict(max_slots=SLOTS, prompt_cap=int(lengths.max()),
                    gen_cap=GEN, block_steps=BLOCK_STEPS)
    dense = layout_twin(Engine, engine, "dense")
    total, total_pg = {}, {}
    for scheme, knobs, want in (("greedy", {}, clean),
                                ("sampled", SAMPLING, clean_sampled)):
        label = f"recovery journal {scheme}"
        jp = os.path.join(workdir, f"{scheme}.jsonl")
        crashed = recovery_engine(Engine, engine, journal=jp,
                                  fault_plan=FaultPlan(crash=(2,)), **knobs)
        try:
            crashed.generate(reqs, **sched_kw)
        except SimulatedCrash as err:
            print(f"[{label}] {err}")
        else:
            raise AssertionError("the run did not crash at boundary 2")
        del crashed
        inflight = [i["req"]["rid"] for i in RequestJournal(jp).replay()
                    .inflight]
        fresh = recovery_engine(Engine, engine, journal=jp, **knobs)
        ops.reset_launches()
        t0 = time.perf_counter()
        done = fresh.recover(**sched_kw)
        wall = time.perf_counter() - t0
        counts, pg = ops.launch_counts(), ops.paged_launch_counts()
        sched = fresh._scheduler
        calls, sec, health = (sched.call_counts(), sched.stage_seconds(),
                              sched.health_stats())
        print(f"[{label}] recover() on a fresh scheduler in {wall:.2f} s "
              f"({sec['compile']:.2f} s of captures, {sec['resume']:.3f} s "
              f"in {calls['resume']} resume prefills) on {kind} ({card}); "
              f"in flight at the crash {inflight}; replayed_tokens "
              f"{health['replayed_tokens']}; health {health}; calls {calls}")
        if sorted(c.rid for c in done) != list(range(N_REQUESTS)) or any(
                (c.status, len(c.tokens)) != ("ok", GEN) for c in done):
            raise AssertionError(f"recovered completions "
                                 f"{[(c.rid, c.status) for c in done]}")
        if calls["resume"] != len(inflight) or health["recoveries"] != 1:
            raise AssertionError(f"{calls['resume']} resume prefills for "
                                 f"{len(inflight)} in-flight requests")
        exact = []
        for c in sorted(done, key=lambda c: c.rid):
            if c.rid not in inflight and c.tokens != want[c.rid]:
                raise AssertionError(f"request {c.rid} was queued at the "
                                     "crash but differs from the clean run")
            if near_tie(torch, A, ST, SG, prng, dense, reqs[c.rid], c.tokens,
                        want[c.rid], label, sampled=scheme == "sampled"):
                exact.append(c.rid)
        print(f"[{label}] {len(exact)}/{N_REQUESTS} completions bit-identical"
              f" to the uninterrupted run; recovered through resume "
              f"bit-identical: {sum(r in exact for r in inflight)}/"
              f"{len(inflight)}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        for k, v in pg.items():
            total_pg[k] = total_pg.get(k, 0) + v
    return total, total_pg


def check_recovery_snapshot(torch, ops, Engine, Request, FaultPlan,
                            SimulatedCrash, layer_caches, engine, kind, card,
                            clean, workdir):
    """[recovery snapshot]: the [scheduler]'s 16 requests with a snapshot at
    every block boundary, crash at boundary 3; on a fresh scheduler whose
    programs are captured first, ``load_state()`` (into the captured
    tensors, in place) and ``resume_run()``: every completion bit for bit
    the clean [scheduler] run's, no resume prefill.  Returns (launch
    counts, paged launch counts)."""
    label = "recovery snapshot"
    lengths, reqs = scheduler_requests(Request, engine.cfg.vocab)
    sched_kw = dict(max_slots=SLOTS, prompt_cap=int(lengths.max()),
                    gen_cap=GEN, block_steps=BLOCK_STEPS)
    snaps = os.path.join(workdir, "snapshots")
    crashed = recovery_engine(Engine, engine, snapshot_every=1,
                              snapshot_dir=snaps,
                              fault_plan=FaultPlan(crash=(3,)))
    try:
        crashed.generate(reqs, **sched_kw)
    except SimulatedCrash as err:
        print(f"[{label}] {err}")
    else:
        raise AssertionError("the run did not crash at boundary 3")
    t0 = time.perf_counter()
    path = crashed.save_state()
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = dir_bytes(path)
    del crashed
    fresh = recovery_engine(Engine, engine, snapshot_dir=snaps)
    sched = fresh.make_scheduler(**sched_kw)
    with torch.inference_mode():
        sched._programs()
    bufs = [t for c in layer_caches(sched._cache)
            for t in (c.k, c.v, c.k_scale, c.v_scale, c.table)]
    bufs += [sched._keys, sched._hist]
    ptrs = [t.data_ptr() for t in bufs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_blocks = sched.load_state()
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    same = [t.data_ptr() for t in layer_caches(sched._cache)
            for t in (t.k, t.v, t.k_scale, t.v_scale, t.table)]
    same += [sched._keys.data_ptr(), sched._hist.data_ptr()]
    ops.reset_launches()
    t0 = time.perf_counter()
    done = sched.resume_run()
    wall = time.perf_counter() - t0
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    calls, health = sched.call_counts(), sched.health_stats()
    exact = sum(c.tokens == clean[c.rid] for c in done)
    print(f"[{label}] snapshot at boundary {n_blocks}: {nbytes} bytes "
          f"({nbytes / 2**20:.1f} MiB; every layer's page pool, scales and "
          f"table, the host state, the prefix store); save_state "
          f"{save_ms:.1f} ms, load_state {load_ms:.1f} ms (into the "
          f"captured tensors, storage kept: {same == ptrs}); resume_run "
          f"{wall:.2f} s; on {kind} ({card})")
    print(f"[{label}] {exact}/{N_REQUESTS} completions bit-identical to the "
          f"clean [scheduler] run; calls {calls}; health {health}")
    if same != ptrs:
        raise AssertionError("load_state rebound the captured tensors")
    if n_blocks != 3 or calls["resume"] != 0 or health["recoveries"] != 1:
        raise AssertionError(f"restored at {n_blocks}, {calls['resume']} "
                             f"resume prefills, health {health}")
    if sorted(c.rid for c in done) != list(range(N_REQUESTS)) or exact != \
            N_REQUESTS:
        raise AssertionError("snapshot-recovered completions differ from "
                             "the clean run")
    return counts, pg, {"bytes": nbytes, "save_ms": save_ms,
                        "load_ms": load_ms}


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))

    from repro_torch.cache import PagedCache, layer_caches
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import api as A
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import prng
    from repro_torch.launch import steps as ST
    from repro_torch.launch import strategies as SG
    from repro_torch.launch.engine import Engine, prepare_int8
    from repro_torch.launch import train
    from repro_torch.launch.faults import FaultPlan, SimulatedCrash
    from repro_torch.launch.journal import RequestJournal
    from repro_torch.launch.scheduler import Request
    from repro_torch.models import build_model
    from repro_torch.shard import ShardedEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card "
          f"(name, power limit):")
    print(card)

    # every library compiles at once: B3's and B5's (the quickest) are
    # checked while the attention libraries compile, those while the
    # D > 128 (_wide) ones, the slowest, do; each is waited for before its
    # first check
    print(f"[progress] imports and the card's name; "
          f"{time.perf_counter() - t_script:.1f} s since the start",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    build.start()
    build.load(["quant_matmul", "fake_quant"])
    build_s = time.perf_counter() - t0
    print(f"[progress] build {build_s:.1f} s", file=sys.stderr, flush=True)
    print(f"[build] quant_matmul and fake_quant built and loaded in "
          f"{build_s:.1f} s; the attention libraries compile on beside "
          "[kernels]")

    dev = torch.device("cuda")
    t_kern = time.perf_counter()

    def progress(label):
        print(f"[progress] {label}; {time.perf_counter() - t_script:.1f} s "
              "since the start", file=sys.stderr, flush=True)

    print(f"[kernels] each kernel against its plain version on {kind} "
          f"({card}); quant_matmul must be bit-exact:")
    kernels = check_quant_matmul(torch, ops, ref, dev)
    check_quant_matmul_edges(torch, ops, ref, dev)
    check_quant_matmul_edges(torch, ops, ref, dev, QMM_DECODE_EDGES,
                             "decode edge")
    print("[kernels] fake_quant (B5) bit-exact, with its STE backward:")
    fq_entries, _ = check_fake_quant(torch, ops, ref, dev)
    print("[kernels] quant_matmul with int4 weights (B3 w_bits=4) "
          "bit-exact:")
    w4_entries, w4_launches = check_quant_matmul_w4(torch, ops, ref, dev)
    print("[kernels] quant_matmul's int32-accumulator branch (B3 acc: a "
          "tensor-parallel shard's partial of a row-parallel layer) bit-"
          "exact at the K slices of smollm-135m (tp=3) and granite-8b "
          "(tp=2):")
    acc_entries = check_quant_matmul_acc(torch, ops, ref, dev)
    print("[kernels] quant_matmul's float32 output (B3 f32: a float32 "
          "config's expert products) bit-exact at every row count of the "
          "paths, int8 and int4 weights; granite-moe-3b-a800m's float32 "
          "expert rows timed:")
    moe_f32_cfg = get_config("granite-moe-3b-a800m").replace(
        dtype=torch.float32)
    f32_entries = []
    experts = tuple((f"expert {name}", k, n)
                    for name, k, n, _ in expert_widths(moe_f32_cfg))
    for wb in (8, 4):
        f32_entries += check_quant_matmul(torch, ops, ref, dev, QMM_F32_ROWS,
                                          torch.float32, wb)
        check_quant_matmul(torch, ops, ref, dev,
                           [(None, m) for _, m in QMM_F32_ROWS],
                           torch.float32, wb, experts,
                           f"{moe_f32_cfg.name} ")
    f32_entries += check_quant_matmul_experts(
        torch, ops, ref, dev, moe_f32_cfg.name, moe_f32_cfg,
        out_dtype=torch.float32)
    progress("B3 and B5 kernels")
    t0 = time.perf_counter()
    build.load([n for n in build.SOURCES if not n.endswith("_wide")])
    attn_wait_s = time.perf_counter() - t0
    print(f"[build] the D <= 128 attention libraries built and loaded "
          f"({attn_wait_s:.1f} s waited for them here); the _wide ones "
          "compile on")
    for bits in (8, 4, 16):
        kernels += check_attention(torch, ops, ref, dev, bits=bits)
    for bits in (8, 4, 16):
        for page in (16, PAGE):
            kernels += check_paged_attention(torch, ops, ref, dev, bits, page)
    for bits in (8, 4):
        kernels.append(check_verify_attention(torch, ops, ref, dev, bits))
    for bits in (8, 4):
        kernels.append(check_partials(torch, ops, ref, dev, bits))
    for bits in (8, 4):
        kernels.append(check_paged_partials(torch, ops, ref, dev, bits))
    kernels += fq_entries + w4_entries + acc_entries + f32_entries
    progress("kernels at smollm-135m's heads")
    print(f"[kernels] prefill_attention over float32 K/V (B2 f32: 3xTF32 "
          f"products) at smollm-135m's and granite-moe's heads, one-shot, "
          f"chunked ({CHUNK} queries at {PROMPT - CHUNK}) and paged (pages of "
          f"16 and {PAGE}), within {F32_ATTN_TOL} x (1 + max|out|) of the "
          "plain version:")
    for heads in ((3, 3, 64), MOE_HEADS):
        kernels += check_attention(torch, ops, ref, dev, 32, *heads)
        for page in (16, PAGE):
            kernels += check_paged_attention(torch, ops, ref, dev, 32, page,
                                             *heads)
    progress("kernels over float32 K/V")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("[kernels] the mixture-of-experts configs: B3 at every expert "
          "product and row count of their paths, at their attention and "
          "lm_head widths; B1 and B2 at granite-moe's heads (KV, G, D) = "
          f"{MOE_HEADS} (B1 paged: its scheduler); B2 at mixtral's window of "
          f"4096 (D 128) over {MIXTRAL_RING_B} x {MIXTRAL_RING_PROMPT}:")
    for arch in MOE_ARCHS:
        cfg_m = path_config(get_config, arch)
        kernels += check_quant_matmul_experts(torch, ops, ref, dev, arch,
                                              cfg_m)
        kernels += check_quant_matmul_widths(
            torch, ops, ref, dev, arch, cfg_m, sms,
            extra_rows=(MIXTRAL_RING_B * MIXTRAL_RING_PROMPT,)
            if cfg_m.window_all else ())
    kernels += check_attention(torch, ops, ref, dev, 8, *MOE_HEADS)
    # the scheduler's admissions prefill a dense batch-1 cache: its paged
    # pool is read by B1 only
    kernels += [e for e in check_paged_attention(torch, ops, ref, dev, 8,
                                                 PAGE, *MOE_HEADS)
                if e["kernel"].startswith("decode_attention")]
    kernels.append(check_window_prefill(
        torch, ops, ref, dev, heads=WIDE_HEADS["granite-8b"],
        b=MIXTRAL_RING_B, s=MIXTRAL_RING_PROMPT, window=4096,
        key="prefill_attention@window@D128"))
    progress("kernels of the MoE configs")
    print("[kernels] the state-space configs: B3 at every projection width "
          "of mamba2-780m and hymba-1.5b (the SSM mixers' six, hymba's "
          "attention and MLP), B1 and B2 at hymba's heads (KV, G, D) = "
          f"{HYMBA_HEADS}, B2 at its window of {WINDOW} over {RING_B} x "
          f"{RING_PROMPT}:")
    for arch in SSM_ARCHS:
        kernels += check_quant_matmul_widths(torch, ops, ref, dev, arch,
                                             get_config(arch), sms)
    kernels += check_attention(torch, ops, ref, dev, 8, *HYMBA_HEADS)
    kernels.append(check_window_prefill(
        torch, ops, ref, dev, heads=HYMBA_HEADS,
        key="prefill_attention@window@hymba"))
    progress("kernels of the state-space configs")
    heads_s = ", ".join(f"{a} {h}" for a, h in MEDIA_HEADS.items())
    print("[kernels] the encoder-decoder and the VLM: B1 and B2 at the heads "
          f"(KV, G, D) of {heads_s} (int8, int4 and bf16 K/V, dense and "
          "paged), B3 at both configs' widths and frontend projections:")
    for heads in MEDIA_HEADS.values():
        for bits in (8, 4, 16):
            kernels += check_attention(torch, ops, ref, dev, bits, *heads)
            kernels += check_paged_attention(torch, ops, ref, dev, bits,
                                             PAGE, *heads)
    for arch in MEDIA_ARCHS:
        cfg_m = get_config(arch)
        # the decoder's prefill rows (4 x 64) of seamless; llava's decode
        # rows (2) and prefill rows (2 x (2880 + 512))
        rows = ((SEAMLESS_B * SEAMLESS_TEXT,) if cfg_m.family == "encdec"
                else (LLAVA_B, LLAVA_B * (cfg_m.mm_patches + LLAVA_TEXT)))
        kernels += check_quant_matmul_widths(torch, ops, ref, dev, arch,
                                             cfg_m, sms, extra_rows=rows)
        kernels.append(check_quant_matmul_frontend(torch, ops, ref, dev, arch,
                                                   cfg_m))
    progress("kernels of the media configs")
    sp_heads = {"granite-moe": MOE_HEADS, **{
        MEDIA_ARCHS[a]: h for a, h in MEDIA_HEADS.items()}}
    print("[kernels] B4 (the sequence-parallel decode's partials) at the "
          "heads (KV, G, D) of the new sp phases, int8 and int4: "
          + ", ".join(f"{k} {h}" for k, h in sp_heads.items()) + " (stablelm-"
          "12b's (8, 4, 160) below):")
    for heads in sp_heads.values():
        for bits in (8, 4):
            kernels.append(check_partials(torch, ops, ref, dev, bits, *heads))
    # the D > 128 heads (the _wide libraries, waited for here) last
    t0 = time.perf_counter()
    build.load()
    wide_wait_s = time.perf_counter() - t0
    print(f"[build] every library built and loaded ({wide_wait_s:.1f} s "
          "waited for the _wide ones here); nvcc wall seconds by library "
          "from the start, in parallel: " + ", ".join(
              f"{k} {v:.1f}" for k, v in build.build_seconds().items()))
    for name, log in build.ptxas_logs().items():
        lines = {line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line}
        for line in sorted(lines):
            print(f"  ptxas {name}: {line}")
    build.dump_sass(("prefill_attention", "prefill_attention_wide",
                     "quant_matmul"))
    check_prefill_sass(build)
    check_decode_attention_spills(build)
    check_quant_matmul_sass(build)
    check_quant_matmul_decode_sass(build, sms)
    progress(f"wide build and SASS checks {time.perf_counter() - t0:.1f} s")
    print("[kernels] B1, B2 and B4 at the heads of granite-8b, stablelm-12b "
          "and gemma3-12b (KV, G, D) = "
          f"{list(WIDE_HEADS.values())}, B2 at gemma3-12b's window, B3 at "
          "their widths:")
    for arch, (kvh, g, d) in WIDE_HEADS.items():
        for bits in (8, 4, 16):
            kernels += check_attention(torch, ops, ref, dev, bits, kvh, g, d)
            kernels += check_paged_attention(torch, ops, ref, dev, bits,
                                             PAGE, kvh, g, d)
        if d > 128:
            for bits in (8, 4):
                kernels.append(check_partials(torch, ops, ref, dev, bits, kvh,
                                              g, d))
    kernels.append(check_window_prefill(torch, ops, ref, dev))
    for arch in WIDE_HEADS:
        kernels += check_quant_matmul_widths(torch, ops, ref, dev, arch,
                                             get_config(arch), sms)
    check_wide_f32_refused(torch, ops, dev)
    progress("kernels of the wider dense configs")

    phases = {"build": build_s, "kernels": time.perf_counter() - t_kern,
              "of which the attention build's wait": attn_wait_s,
              "of which the wide build's wait": wide_wait_s}
    progress(f"kernels {phases['kernels']:.1f} s")

    failures = []

    def phase(name, fn, *args, **kw):
        """Run one checked phase and time it; a failed check is recorded
        and the later phases still run, so one run reports them all."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        except AssertionError as err:
            failures.append(f"[{name}] {err}")
            print(f"[{name}] FAILED: {err}")
            return None
        finally:
            phases[name] = time.perf_counter() - t0
            # where a run stands, on the stream that is not buffered
            print(f"[progress] {name} {phases[name]:.1f} s; "
                  f"{time.perf_counter() - t_script:.1f} s since the start",
                  file=sys.stderr, flush=True)

    # the paper's side (ROADMAP items 16, 15): its tables, and its FAT
    # variants at full width served in int8
    paper = phase("paper tables", check_paper_tables, torch, ops, dev, card)
    variants = phase("variants full", check_variants_full, torch, ops, A, ST,
                     Engine, prepare_int8, build_model, get_config, dev,
                     kind, card)
    free_card(torch)
    dryrun_runs = phase("dryrun", drive_dryrun_phase, torch, ops, card) or {}

    t0 = time.perf_counter()
    engine = Engine.from_checkpoint("smollm-135m", smoke=False)
    torch.cuda.synchronize()
    print(f"[engine] smollm-135m full width: init + calibration + int8 "
          f"conversion in {time.perf_counter() - t0:.1f} s; "
          f"{engine.n_int8_weights()} int8 weight tensors")
    phases["int8 engine"] = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, engine.cfg.vocab, (B, PROMPT), dtype=np.int32)
    # [graphs]: per path, the captured programs' walls against the eager
    # loop=True driver's, and the device busy of each
    walls: dict = {}
    res, counts, *_ = drive_main_path(torch, ops, engine, prompts,
                                      "main path", kind, card, walls=walls,
                                      A=A)
    phases["main path"] = time.perf_counter() - t0 - phases["int8 engine"]
    phase("graphs profiler", profile_graph_replay, torch, engine, card)
    phase("breakdown", breakdown, torch, engine, prompts, card,
          "breakdown", walls, "main path")
    phase("cpu check", cpu_check, torch, A, engine, prompts,
          res.tokens.cpu(), LOGIT_ATOL, "cpu check")
    # the main engine's first SMOLLM_LAYERS layers, for the script's time,
    # and its greedy tokens (the speculative paths' reference)
    engine_s = cut_engine(Engine, build_model, engine, SMOLLM_LAYERS)
    engine_s.generate_batch({"tokens": prompts}, gen=2)
    greedy_s = engine_s.generate_batch({"tokens": prompts}, gen=GEN).tokens
    phase("graphs paged 16", drive_paged_path, torch, ops, ref, Engine,
          PagedCache, engine_s, prompts, "graphs paged 16", kind, card, 16, A,
          walls)
    # the decoding strategies beside greedy, each path's launches counted
    # from 0: sampled, and speculative (its verify windows through B2),
    # dense and in pages of 16
    sample = phase("sample path", drive_sample_path, torch, ops, A, SG, prng,
                   Engine, engine_s, prompts, kind, card, walls)
    spec_runs = {}
    for page in (None, 16):
        name = "speculative path" if page is None else "speculative paged 16"
        spec_runs[name] = phase(name, drive_spec_path, torch, ops, A, ST, SG,
                                prng, Engine, engine_s, prompts, greedy_s,
                                name, kind, card, page, walls)
    # tensor parallelism as the reference serves it (ROADMAP item 18): the
    # same weights as ShardedEngine(tp=TP), through its captured programs
    # and eagerly, against the unsharded engine and the CPU; then the
    # scheduler
    tp_runs = {
        "tp path": phase("tp path", drive_tp_phase, torch, ops, A,
                         ShardedEngine, engine, {"tokens": prompts},
                         "tp path", kind, card, TP, walls, True,
                         2 * engine.cfg.n_layers),
        "tp scheduler": phase("tp scheduler", check_tp_scheduler, torch,
                              ops, A, ST, ShardedEngine, Request, engine_s,
                              kind, card)}
    # the same shards as TP processes on the one card (item 18's ranks)
    tp_runs["tp ranks"] = phase(
        "tp ranks", drive_rank_phase, torch, ops, A, ST,
        ShardedEngine(engine.model, engine.cfg, engine.policy,
                      engine.serve_params, engine.qparams,
                      device=engine.device, tp=TP,
                      cache_layout=engine.cache_layout),
        {"tokens": prompts}, "tp ranks", kind, card)
    # the analysis contracts (ROADMAP item 19) on the card
    analysis = phase("analysis", check_analysis, torch, ops, ShardedEngine,
                     engine, kind, card)
    if analysis is not None:
        print("[analysis] seconds: " + "; ".join(
            f"{k} {v:.1f}" for k, v in analysis.items()) + f"; phase "
            f"{phases['analysis']:.1f} s ({card})")
    del engine, engine_s

    # the reference's three other serving modes at full width (and
    # SMOLLM_LAYERS of 30, as the paged, scheduler and sp engines below):
    # bf16 weights and/or a bf16 KV cache; the bf16-KV launches of each path
    smollm_cut = get_config("smollm-135m").replace(n_layers=SMOLLM_LAYERS)
    bf16_runs, paged_bf16 = {}, None
    # the sequence-parallel phases of this slice, by label: (launch counts,
    # int4 variants), each read from its timed run
    sp_runs = {}
    for name, flags in SERVING_MODES.items():
        t0 = time.perf_counter()
        eng = Engine.from_checkpoint(cfg=smollm_cut, smoke=False, **flags)
        torch.cuda.synchronize()
        phases[f"{name} engine"] = time.perf_counter() - t0
        print(f"[{name}] smollm-135m full width, {SMOLLM_LAYERS} of its 30 "
              f"layers, fp={flags['fp']}, "
              f"kv_int8={flags['kv_int8']}: engine built in "
              f"{phases[name + ' engine']:.1f} s; {eng.n_int8_weights()} int8 "
              f"weight tensors; {len(eng.qparams)} qparams entries")
        out = phase(name, drive_main_path, torch, ops, eng, prompts, name,
                    kind, card, 1, walls, A)
        if out is None:
            continue
        bf16_runs[f"{name} main path"] = out[3]
        phase(f"{name} breakdown", breakdown, torch, eng, prompts, card,
              f"{name} breakdown", walls, name)
        phase(f"{name} cpu check", cpu_check, torch, A, eng, prompts,
              out[0].tokens.cpu(), LOGIT_ATOL, f"{name} cpu check")
        if name == "int8_w_bf16_kv":
            paged_bf16 = phase(f"{name} paged path", drive_paged_path, torch,
                               ops, ref, Engine, PagedCache, eng, prompts,
                               f"{name} paged path", kind, card, PAGE, A,
                               walls)
        if name == "bf16_w_bf16_kv":
            probe = phase("graphs cublas probe", cublas_capture_probe, torch,
                          eng)
            print(f"[graphs cublas probe] the cuBLAS products of the bf16 "
                  f"paths at decode shapes, bits equal captured vs eager: "
                  f"{probe}")
            sched = phase(f"{name} scheduler", check_scheduler, torch, ops, A,
                          ST, Engine, Request,
                          layout_twin(Engine, eng, "paged"), kind, card,
                          SLOTS, 2, f"{name} scheduler")
            if sched is not None:
                bf16_runs[f"{name} scheduler"] = sched[1]
        # the same weights with SP sequence shards (no new draw)
        label = f"sp bf16 paths {name}"
        sp_runs[label] = phase(label, drive_sp_phase, torch, ops, A, ST, SG,
                               prng, ShardedEngine, build_model, eng,
                               {"tokens": prompts}, label, kind, card)
        del eng

    # the float32 configs (ROADMAP Queue B's float32 branches of B2 and B3):
    # smollm-135m in both float-cache modes at full width and depth, then
    # its paged twin at F32_PAGED_LAYERS
    smollm_f32 = get_config("smollm-135m").replace(dtype=torch.float32)
    f32_runs = {}
    for mode in F32_MODES:
        label = f"float32 path {mode}"
        f32_runs[label] = phase(label, drive_f32_path, torch, ops, A, Engine,
                                smollm_f32, prompts, mode, label, kind, card,
                                walls)
    f32_runs["float32 paged"] = phase(
        "float32 paged", drive_f32_paged, torch, ops, ref, A, Engine,
        PagedCache, build_model, smollm_f32, prompts, "float32 paged", kind,
        card, walls)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine4 = Engine.from_checkpoint(cfg=smollm_cut, smoke=False, kv_bits=4,
                                     finetune_thresholds=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[finetune] smollm-135m full width, {SMOLLM_LAYERS} of its 30 "
          f"layers, kv_bits=4, 2 epochs x 2 "
          f"calibration batches of 4 x 32: init + calibration + fine-tune "
          f"+ int8 conversion in {time.perf_counter() - t0:.1f} s; peak "
          f"device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated)")
    phases["int4 engine"] = time.perf_counter() - t0
    phase("finetune", check_finetune, torch, A, ST, engine4, card)
    out4 = phase("int4 path", drive_main_path, torch, ops, engine4, prompts,
                 "int4 path", kind, card, 1, walls, A)
    if out4 is not None:
        phase("int4 breakdown", breakdown, torch, engine4, prompts, card,
              "int4 breakdown", walls, "int4 path")
        phase("int4 cpu check", cpu_check, torch, A, engine4, prompts,
              out4[0].tokens.cpu(), LOGIT_ATOL_INT4, "int4 cpu check")
    paged4 = phase("int4 paged path", drive_paged_path, torch, ops, ref,
                   Engine, PagedCache, engine4, prompts, "int4 paged path",
                   kind, card, PAGE, A, walls)
    spec4_runs = {}
    if out4 is not None:
        for page in (None, 16):
            name = ("int4 speculative path" if page is None
                    else "int4 speculative paged 16")
            spec4_runs[name] = phase(name, drive_spec_path, torch, ops, A, ST,
                                     SG, prng, Engine, engine4, prompts,
                                     out4[0].tokens, name, kind, card, page,
                                     walls)
    sp4 = phase("int4 sp path", drive_main_path, torch, ops, ShardedEngine(
        engine4.model, engine4.cfg, engine4.policy, engine4.serve_params,
        engine4.qparams, device=engine4.device, sp=SP), prompts,
        "int4 sp path", kind, card, SP, None, A)
    del engine4

    t0 = time.perf_counter()
    engine_p = Engine.from_checkpoint(cfg=smollm_cut, smoke=False,
                                      cache_layout="paged", page_size=PAGE,
                                      prefill_chunk=CHUNK)
    torch.cuda.synchronize()
    phases["paged engine"] = time.perf_counter() - t0
    # the paged launches of each of this slice's paths, each counted from 0
    paged_runs = {
        "paged path": phase("paged path", drive_paged_path, torch, ops, ref,
                            Engine, PagedCache, engine_p, prompts,
                            "paged path", kind, card, PAGE, A, walls)}
    phase("paged breakdown", breakdown, torch, engine_p, prompts, card,
          "paged breakdown", walls, "paged path")
    paged_runs.update({
        "scheduler": phase("scheduler", check_scheduler, torch, ops, A, ST,
                           Engine, Request, engine_p, kind, card),
        "prefix": phase("prefix", check_prefix, torch, ops, Request,
                        engine_p, kind, card)})
    strategy_scheds = {
        f"{scheme} scheduler": phase(
            f"{scheme} scheduler", check_strategy_scheduler, torch, ops, A,
            ST, SG, prng, Engine, Request, engine_p, kind, card, scheme)
        for scheme in ("speculative", "sample")}
    # resilience and durability (launch/faults.py, launch/journal.py): the
    # [scheduler]'s requests under a fault plan, dense and paged, then a
    # crashed run recovered from its journal and from a snapshot, each
    # against the clean runs above
    resilience = {}
    if paged_runs["scheduler"] is None or strategy_scheds[
            "sample scheduler"] is None:
        failures.append("[resilience] and [recovery ...] not run: the clean "
                        "[scheduler] or [sampled scheduler] run failed")
    else:
        clean = {c.rid: c.tokens for c in paged_runs["scheduler"][2]}
        clean_sampled = {c.rid: c.tokens
                         for c in strategy_scheds["sample scheduler"][2]}
        for layout in ("dense", "paged"):
            resilience[f"resilience {layout}"] = phase(
                f"resilience {layout}", check_resilience, torch, ops, A, ST,
                SG, prng, Engine, Request, FaultPlan, engine_p, kind, card,
                layout, clean)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_wal_") as wd:
            resilience["recovery journal"] = phase(
                "recovery journal", check_recovery_journal, torch, ops, A, ST,
                SG, prng, Engine, Request, FaultPlan, SimulatedCrash,
                RequestJournal, engine_p, kind, card, clean, clean_sampled,
                wd)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as wd:
            resilience["recovery snapshot"] = phase(
                "recovery snapshot", check_recovery_snapshot, torch, ops,
                Engine, Request, FaultPlan, SimulatedCrash, layer_caches,
                engine_p, kind, card, clean, wd)
    del engine_p

    t0 = time.perf_counter()
    engine_sp = ShardedEngine.from_checkpoint(cfg=smollm_cut, smoke=False,
                                              sp=SP)
    torch.cuda.synchronize()
    phases["sp engine"] = time.perf_counter() - t0
    out_sp = phase("sp path", drive_main_path, torch, ops, engine_sp,
                   prompts, "sp path", kind, card, SP, None, A)
    if out_sp is not None:
        phase("sp breakdown", breakdown, torch, engine_sp, prompts, card,
              "sp breakdown")
        phase("sp cpu check", cpu_check, torch, A, engine_sp, prompts,
              out_sp[0].tokens.cpu(), LOGIT_ATOL, "sp cpu check")
    sp_sched = phase("sp scheduler", check_sp_scheduler, torch, ops, A, ST,
                     Engine, ShardedEngine, Request, engine_sp, kind, card)
    phase("analysis sp", check_analysis_sp, torch, ops, engine_sp, card)
    if out_sp is not None:
        sp_runs["sp speculative"] = phase(
            "sp speculative", drive_sp_phase, torch, ops, A, ST, SG, prng,
            ShardedEngine, build_model, engine_sp, {"tokens": prompts},
            "sp speculative", kind, card, greedy=out_sp[0].tokens,
            **SPECULATIVE)
        # the [sp path]'s engine as SP processes on the one card
        sp_runs["sp ranks"] = (phase(
            "sp ranks", drive_rank_phase, torch, ops, A, ST, engine_sp,
            {"tokens": prompts}, "sp ranks", kind, card,
            want=(out_sp[0], out_sp[1]), trace=True)[0], None)
    del engine_sp

    # the training driver; its checkpoints live in temporary directories
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fat_") as workdir:
        phase("train fat_qat", check_train_fat, torch, train, A, workdir,
              card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre_") as workdir:
        phase("train pretrain + checkpoint serve", check_train_pretrain,
              torch, ops, A, train, Engine, CheckpointManager, prompts,
              workdir, kind, card)
    # the wider dense configs at full width and PATH_LAYERS, one at a time
    # (8-12 B parameters each): their main paths, gemma3-12b's rings, and a
    # full-width copy of depth 2 of each against the CPU
    arch_runs, ring_run = {}, None
    for arch in WIDE_HEADS:
        label = f"{arch} path"
        run = phase(label, drive_arch_path, torch, ops, A, Engine,
                    build_model, path_config(get_config, arch), label, kind,
                    card, walls)
        if run is not None:
            engine_w, arch_runs[arch] = run
            if arch == "gemma3-12b":
                ring_run = phase("gemma3-12b ring", drive_ring_path, torch,
                                 ops, A, Engine, engine_w, "gemma3-12b ring",
                                 kind, card, walls)
            if arch == "granite-8b":
                tp_runs["granite-8b tp"] = phase(
                    "granite-8b tp", drive_tp_phase, torch, ops, A,
                    ShardedEngine, engine_w, {"tokens": np.random.default_rng(
                        sum(map(ord, arch))).integers(
                            0, engine_w.cfg.vocab, (B, PROMPT),
                            dtype=np.int32)},
                    "granite-8b tp", kind, card, TP_WIDE, walls, False,
                    2 * engine_w.cfg.n_layers)
            if arch == "stablelm-12b":
                # B4 at D 160 on a model path: the same weights, sp=SP
                sp_runs["stablelm sp"] = phase(
                    "stablelm sp", drive_sp_phase, torch, ops, A, ST, SG,
                    prng, ShardedEngine, build_model, engine_w,
                    {"tokens": np.random.default_rng(sum(map(
                        ord, arch))).integers(0, engine_w.cfg.vocab,
                                              (B, PROMPT), dtype=np.int32)},
                    "stablelm sp", kind, card,
                    cpu_over=dict(n_layers=SP_CPU_LAYERS))
            del engine_w, run
        phase(f"{arch} cpu check", check_arch_cpu, torch, ops, A, Engine,
              build_model, get_config(arch), f"{arch} cpu check")
    # the mixture-of-experts configs (ROADMAP item 17 step 4) at full width:
    # each main path (every expert product through B3, once per expert),
    # granite-moe through the scheduler at drop-free capacity, mixtral's
    # rings, and a full-width copy of depth 2 of each against the CPU
    moe_runs = {}
    for arch, short in MOE_ARCHS.items():
        run = phase(short, drive_arch_path, torch, ops, A, Engine,
                    build_model, path_config(get_config, arch), short, kind,
                    card, walls)
        if run is not None:
            engine_m, moe_runs[short] = run
            if arch == "granite-moe-3b-a800m":
                moe_runs["granite-moe scheduler"] = phase(
                    "granite-moe scheduler", check_moe_scheduler, torch, ops,
                    A, ST, Engine, Request, build_model, engine_m, kind,
                    card, "granite-moe scheduler")
                sp_runs["granite-moe sp"] = phase(
                    "granite-moe sp", drive_sp_phase, torch, ops, A, ST, SG,
                    prng, ShardedEngine, build_model, engine_m,
                    {"tokens": np.random.default_rng(sum(map(
                        ord, arch))).integers(0, engine_m.cfg.vocab,
                                              (B, PROMPT), dtype=np.int32)},
                    "granite-moe sp", kind, card,
                    cpu_over=dict(n_layers=SP_CPU_LAYERS))
            else:
                moe_runs["mixtral ring"] = phase(
                    "mixtral ring", drive_ring_path, torch, ops, A, Engine,
                    engine_m, "mixtral ring", kind, card, walls,
                    MIXTRAL_RING_B, MIXTRAL_RING_PROMPT, 4096)
            del engine_m, run
        phase(f"{short} cpu check", check_arch_cpu, torch, ops, A, Engine,
              build_model, get_config(arch), f"{short} cpu check")
    # granite-moe built with dtype float32: its experts through B3's
    # float32 output
    moe_f32 = phase("granite-moe float32", drive_moe_f32, torch, ops, A,
                    Engine, build_model, get_config, "granite-moe float32",
                    kind, card, walls)
    # the state-space configs (ROADMAP item 17 steps 5-6) at full width and
    # PATH_LAYERS: mamba2's main path (no attention kernel: B3 alone) and one
    # sampled run, hymba's main path and its rings of 1024, and a full-width
    # copy of depth 2 of each against the CPU
    ssm_runs = {}
    for arch, short in SSM_ARCHS.items():
        run = phase(short, drive_arch_path, torch, ops, A, Engine,
                    build_model, path_config(get_config, arch), short, kind,
                    card, walls)
        if run is not None:
            engine_s, ssm_runs[short] = run
            if arch == "mamba2-780m":
                prompts_s = np.random.default_rng(5).integers(
                    0, engine_s.cfg.vocab, (B, PROMPT), dtype=np.int32)
                sampled = phase("mamba2 sample", drive_sample_path, torch,
                                ops, A, SG, prng, Engine, engine_s,
                                prompts_s, kind, card, walls,
                                "mamba2 sample", False)
                if sampled is not None:
                    ssm_runs["mamba2 sample"] = (sampled[1],)
                cut = cut_engine(Engine, build_model, engine_s,
                                 MAMBA2_SP_LAYERS)
                sp_runs["mamba2 sp"] = phase(
                    "mamba2 sp", drive_sp_phase, torch, ops, A, ST, SG, prng,
                    ShardedEngine, build_model, cut, {"tokens": prompts_s},
                    "mamba2 sp", kind, card)
                del cut
            else:
                ring = cut_engine(Engine, build_model, engine_s,
                                  HYMBA_RING_LAYERS)
                ssm_runs["hymba ring"] = phase(
                    "hymba ring", drive_ring_path, torch, ops, A, Engine,
                    ring, "hymba ring", kind, card, walls)
                del ring
            del engine_s, run
        phase(f"{short} cpu check", check_arch_cpu, torch, ops, A, Engine,
              build_model, get_config(arch), f"{short} cpu check")
    # the encoder-decoder and the VLM (ROADMAP item 17 steps 7-8) at full
    # width, seamless at full depth and llava at PATH_LAYERS: each main path
    # through the Engine, and a full-width copy of depth 2 of each against
    # the CPU
    media_runs = {}
    for arch, short in MEDIA_ARCHS.items():
        run = phase(short, drive_media_path, torch, ops, A, Engine,
                    build_model, path_config(get_config, arch), short, kind,
                    card, walls)
        if run is not None:
            engine_m, media_runs[short] = run
            vlm = engine_m.cfg.modality == "vlm"
            batch = (media_batch(engine_m.cfg, LLAVA_B, LLAVA_TEXT, 0, 13)
                     if vlm else media_batch(engine_m.cfg, SEAMLESS_B,
                                             SEAMLESS_TEXT, SEAMLESS_FRAMES,
                                             13))
            sp_runs[f"{short} sp"] = phase(
                f"{short} sp", drive_sp_phase, torch, ops, A, ST, SG, prng,
                ShardedEngine, build_model, engine_m, batch, f"{short} sp",
                kind, card,
                cpu_over=dict(mm_patches=CPU_MM_PATCHES,
                              n_layers=SP_CPU_LAYERS) if vlm else None)
            if not vlm:
                tp_runs["seamless tp"] = phase(
                    "seamless tp", drive_tp_phase, torch, ops, A,
                    ShardedEngine, engine_m, batch, "seamless tp", kind,
                    card, TP_WIDE, walls)
            del engine_m, run
        phase(f"{short} cpu check", check_media_cpu, torch, ops, A, Engine,
              build_model, get_config(arch), f"{short} cpu check")
    free_card(torch)
    print_walls(walls, card)
    print("[time] " + "; ".join(f"{k} {v:.1f} s" for k, v in phases.items()))
    if failures:
        print("chip_smoke: failed checks:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1

    # the resilience and recovery runs: their paged decode launches join
    # the @paged entries, their dense launches (the admission and resume
    # prefills into the dense template, the dense run's decode) the int8
    # entries
    for path, run in resilience.items():
        if "dense" not in path:
            paged_runs[path] = run[:2]
    dense_by_path = {path: {k: run[0][k] - run[1][k]
                            for k in ("prefill_attention",
                                      "decode_attention")}
                     for path, run in resilience.items()}
    # the tensor-parallel phases: B3's int32-accumulator launches by path;
    # smollm-135m's paths' fused B3 and attention launches join the main
    # entries, the wider configs' their configs' entries
    acc_by_path = {path: run[1] for path, run in tp_runs.items()}
    smollm_tp = ("tp path", "tp scheduler", "tp ranks")
    dense_by_path.update({path: tp_runs[path][0] for path in smollm_tp})
    by_path = {path: run[-1] for path, run in paged_runs.items()}
    partials = "decode_attention_partials"
    sp_paths = {"sp path": out_sp[1][partials],
                "sp scheduler": sp_sched[partials]}
    launched = {**counts, **{f"{k}@int4": n for k, n in out4[2].items()},
                **{f"{k}@paged-int4": n for k, n in paged4[-1].items()},
                **{f"{k}@paged": sum(pg[k] for pg in by_path.values())
                   for k in ops.ATTENTION},
                partials: sum(sp_paths.values()),
                f"{partials}@int4": sp4[2][partials],
                "fake_quant": paper["fake_quant"],
                "quant_matmul@w4": w4_launches}
    # the strategies' paths: B3's launches join the main path's; B2's in the
    # verify windows are prefill_attention@verify (int8) and
    # @verify-int4
    new_paths = {"sample path": sample[1],
                 **{k: v[0] for k, v in {**spec_runs, **spec4_runs}.items()},
                 **{k: v[0] for k, v in strategy_scheds.items()}}
    new_paths.update({path: run[0] for path, run in resilience.items()})
    new_paths["paper tables"] = {"quant_matmul": paper["quant_matmul"]}
    new_paths.update({f"variants full {name}": {"quant_matmul": n}
                      for name, n in variants.items()})
    new_paths.update({path: tp_runs[path][0] for path in smollm_tp})
    # [dryrun]: smollm-135m's prefill cell joins the main entries (B3, and
    # B2's bf16 variant), granite-8b's decode cell its config's B3 (below)
    if "dryrun chip_prefill" in dryrun_runs:
        c, bf16 = dryrun_runs["dryrun chip_prefill"]
        new_paths["dryrun chip_prefill"] = c
        bf16_runs["dryrun chip_prefill"] = bf16
    launched["quant_matmul"] += sum(c["quant_matmul"]
                                    for c in new_paths.values())
    for k in ("prefill_attention", "decode_attention"):
        launched[k] += sum(d[k] for d in dense_by_path.values())
    verify_by_path = {k: v[1] for k, v in spec_runs.items()}
    verify_by_path["speculative scheduler"] = strategy_scheds[
        "speculative scheduler"][1]["prefill_attention"]
    verify4_by_path = {k: v[1] for k, v in spec4_runs.items()}
    launched["prefill_attention@verify"] = sum(verify_by_path.values())
    launched["prefill_attention@verify-int4"] = sum(verify4_by_path.values())
    bf16_by_path = {path: pg["prefill_attention"]
                    for path, pg in bf16_runs.items()}
    launched["prefill_attention@bf16"] = sum(bf16_by_path.values())
    launched["prefill_attention@paged-bf16"] = paged_bf16[-1][
        "prefill_attention"]
    # the wider configs' paths, every count read from the counters of the
    # path's timed run (``drive_main_path``): B1, B2 and B4 by head dim and
    # variant, B3 by config, B2 with gemma3-12b's window on both of its
    # paths.  A paged int4 or bf16 launch adds one to the paged counter and
    # to the int4 or bf16 one: the smaller of the two bounds it, and is its
    # count here, where the paged counter is checked to be 0.
    wide_by_path = {}
    for arch, (kvh, g, d) in WIDE_HEADS.items():
        runs = {f"{arch} path": arch_runs[arch]}
        if arch == "gemma3-12b":
            runs["gemma3-12b ring"] = ring_run
        for path, (c, int4, bf16, pg, win) in runs.items():
            got = {f"quant_matmul@{arch}": c["quant_matmul"],
                   f"{partials}@D{d}": c[partials],
                   f"{partials}@int4@D{d}": int4[partials],
                   f"prefill_attention@bf16@D{d}": bf16["prefill_attention"],
                   f"prefill_attention@paged-bf16@D{d}": min(
                       pg["prefill_attention"], bf16["prefill_attention"])}
            if arch == "gemma3-12b":
                got["prefill_attention@window"] = win["prefill_attention"]
            for k in ("prefill_attention", "decode_attention"):
                got.update({f"{k}@D{d}": c[k], f"{k}@int4@D{d}": int4[k],
                            f"{k}@paged@D{d}": pg[k],
                            f"{k}@paged-int4@D{d}": min(pg[k], int4[k])})
            for kernel, n in got.items():
                wide_by_path.setdefault(kernel, {})[path] = n
    # the mixture-of-experts paths: B3 by config (attention, experts and
    # mixtral's lm_head), B1 / B2 at granite-moe's heads (its scheduler's
    # admissions are dense B2, its decode paged B1), B2 with mixtral's
    # window on both of its paths
    for path, run in moe_runs.items():
        if path == "granite-moe scheduler":
            c, _, _, pg = run
            got = {"quant_matmul@granite-moe-3b-a800m": c["quant_matmul"],
                   "prefill_attention@D64": c["prefill_attention"]
                   - pg["prefill_attention"],
                   "decode_attention@paged@D64": pg["decode_attention"]}
        elif path == "granite-moe":
            c = run[0]
            got = {"quant_matmul@granite-moe-3b-a800m": c["quant_matmul"],
                   "prefill_attention@D64": c["prefill_attention"],
                   "decode_attention@D64": c["decode_attention"]}
        else:
            c, win = run[0], run[4]
            got = {"quant_matmul@mixtral-8x7b": c["quant_matmul"],
                   "prefill_attention@window@D128": win["prefill_attention"]}
        for kernel, n in got.items():
            wide_by_path.setdefault(kernel, {})[path] = n
    # the state-space paths: B3 by config; B1 / B2 at hymba's heads on its
    # global layers (and B2 on its windowed ones, with the window)
    for path, run in ssm_runs.items():
        c = run[0]
        arch = "mamba2-780m" if path.startswith("mamba2") else "hymba-1.5b"
        got = {f"quant_matmul@{arch}": c["quant_matmul"]}
        if arch == "hymba-1.5b":
            got.update({"prefill_attention@hymba": c["prefill_attention"],
                        "decode_attention@hymba": c["decode_attention"],
                        "prefill_attention@window@hymba":
                            run[4]["prefill_attention"]})
        for kernel, n in got.items():
            wide_by_path.setdefault(kernel, {})[path] = n
    # the encoder-decoder and the VLM: B3 by config (frontend, encoder,
    # decoder and cross attention, llava's lm_head), B1 / B2 at their heads
    # by variant (the int4, bf16 and paged ones 0: their paths serve int8
    # dense caches)
    media_arch = {short: arch for arch, short in MEDIA_ARCHS.items()}
    for short, (c, int4, bf16, pg, _) in media_runs.items():
        arch = media_arch[short]
        got = {f"quant_matmul@{arch}": c["quant_matmul"],
               f"prefill_attention@bf16@{short}": bf16["prefill_attention"],
               f"prefill_attention@paged-bf16@{short}": min(
                   pg["prefill_attention"], bf16["prefill_attention"])}
        for k in ("prefill_attention", "decode_attention"):
            got.update({f"{k}@{short}": c[k], f"{k}@int4@{short}": int4[k],
                        f"{k}@paged@{short}": pg[k],
                        f"{k}@paged-int4@{short}": min(pg[k], int4[k])})
        for kernel, n in got.items():
            wide_by_path.setdefault(kernel, {})[short] = n
    # this slice's sp phases: B4 by head geometry (smollm-135m's bf16 modes
    # and speculative window join the [sp path]'s entry), B3 by config
    sp_key = {"stablelm sp": "@D160", "granite-moe sp": "@D64",
              "seamless sp": "@seamless", "llava sp": "@llava",
              "mamba2 sp": None}
    sp_arch = {"stablelm sp": "stablelm-12b",
               "granite-moe sp": "granite-moe-3b-a800m",
               "seamless sp": "seamless-m4t-medium",
               "llava sp": "llava-next-34b", "mamba2 sp": "mamba2-780m"}
    for path, (c, int4) in sp_runs.items():
        if path not in sp_key:
            sp_paths[path] = c[partials]
            new_paths[path] = c
            continue
        got = {f"quant_matmul@{sp_arch[path]}": c["quant_matmul"]}
        if sp_key[path]:
            got[partials + sp_key[path]] = c[partials]
            got[f"{partials}@int4{sp_key[path]}"] = int4[partials]
        for kernel, n in got.items():
            wide_by_path.setdefault(kernel, {})[path] = n
    tp_keys = {"granite-8b tp": ("granite-8b", "@D128"),
               "seamless tp": ("seamless-m4t-medium", "@seamless")}
    for path, (arch, key) in tp_keys.items():
        c = tp_runs[path][0]
        got = {f"quant_matmul@{arch}": c["quant_matmul"],
               f"prefill_attention{key}": c["prefill_attention"],
               f"decode_attention{key}": c["decode_attention"]}
        for kernel, n in got.items():
            wide_by_path.setdefault(kernel, {})[path] = n
    if "dryrun chip_decode" in dryrun_runs:
        wide_by_path.setdefault("quant_matmul@granite-8b", {})[
            "dryrun chip_decode"] = dryrun_runs["dryrun chip_decode"][0][
                "quant_matmul"]
    # the float32 paths, each variant from its counters: B2's float32
    # branch by path and layout (granite-moe's float32 path serves the
    # default int8 cache), B3's bf16 launches (smollm's layers, granite-
    # moe's attention) join their entries, B3's float32 output by config
    # (smollm's float32 paths have no experts); a float32 variant of two
    # counters (paged, int4 weights) takes the smaller, as the media
    # paths' do
    c, pg, f = moe_f32
    f32_by_path, f32_qmm, f32_w4 = {}, 0, min(f["quant_matmul"],
                                             f["quant_matmul_w4"])
    for path, run in f32_runs.items():
        new_paths[path] = run[0]
        launched["quant_matmul"] += run[0]["quant_matmul"]
        f32_qmm += run[1]["quant_matmul"]
        if path == "float32 paged":
            launched["prefill_attention@paged-f32"] = min(
                run[1]["prefill_attention"], run[2]["prefill_attention"])
        else:
            f32_by_path[path] = run[1]["prefill_attention"]
            f32_w4 += min(run[1]["quant_matmul"], run[1]["quant_matmul_w4"])
    launched.update({
        "prefill_attention@f32": sum(f32_by_path.values()),
        "prefill_attention@f32@D64": f["prefill_attention"],
        "prefill_attention@paged-f32@D64": min(pg["prefill_attention"],
                                               f["prefill_attention"]),
        "quant_matmul@f32": f32_qmm, "quant_matmul@f32-w4": f32_w4})
    for kernel, n in {
            "quant_matmul@f32@granite-moe-3b-a800m": f["quant_matmul"],
            "quant_matmul@granite-moe-3b-a800m":
                c["quant_matmul"] - f["quant_matmul"],
            "prefill_attention@D64": c["prefill_attention"],
            "decode_attention@D64": c["decode_attention"]}.items():
        wide_by_path.setdefault(kernel, {})["granite-moe float32"] = n
    launched["quant_matmul@acc"] = sum(acc_by_path.values())
    launched[partials] = sum(sp_paths.values())
    launched["quant_matmul"] += sum(sp_runs[p][0]["quant_matmul"]
                                    for p in sp_runs if p not in sp_key)
    for kernel, paths in wide_by_path.items():
        launched[kernel] = sum(paths.values())
    for e in kernels:
        kernel = e.pop("kernel")
        e["launches"] = launched[kernel]
        if kernel in wide_by_path:
            e["launches_by_path"] = wide_by_path[kernel]
        if kernel.endswith("@paged"):
            e["launches_by_path"] = {path: pg[kernel.split("@")[0]]
                                     for path, pg in by_path.items()}
        if kernel == partials:
            e["launches_by_path"] = sp_paths
        if kernel == "prefill_attention@bf16":
            e["launches_by_path"] = bf16_by_path
        if kernel == "prefill_attention@f32":
            e["launches_by_path"] = f32_by_path
        if kernel == "prefill_attention@paged-f32":
            e["launches_by_path"] = {"float32 paged": launched[kernel]}
        if kernel == "prefill_attention@verify":
            e["launches_by_path"] = verify_by_path
        if kernel == "prefill_attention@verify-int4":
            e["launches_by_path"] = verify4_by_path
        if kernel == "quant_matmul":
            e["launches_by_path"] = {"main path": counts["quant_matmul"],
                                     **{k: c["quant_matmul"]
                                        for k, c in new_paths.items()}}
        if kernel in ("prefill_attention", "decode_attention"):
            e["launches_by_path"] = {"main path": counts[kernel],
                                     **{path: d[kernel] for path, d in
                                        dense_by_path.items()}}
        if kernel == "fake_quant":
            e["launches_by_path"] = {"paper tables": launched[kernel]}
        if kernel == "quant_matmul@acc":
            e["launches_by_path"] = acc_by_path
        if kernel == "prefill_attention@paged-bf16":
            e["launches_by_path"] = {"int8_w_bf16_kv paged path":
                                     launched[kernel]}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
