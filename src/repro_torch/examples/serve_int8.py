"""Serve a FAT-quantized model with batched requests (int8 weights).

The two serving surfaces:

  1. the serve CLI (``repro_torch.launch.serve``, flags over the Engine):
     int8 against bf16 weights, chunked ragged prefill with nucleus
     sampling, the continuous-batching scheduler, speculative decoding and
     an int4 KV cache with trained thresholds;
  2. the ``Engine`` facade directly: the paged cache layout turns repeated
     prompts into admissions with no prefill through the prefix store.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_int8 [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.launch import serve

SMOKE = ["--arch", "smollm-135m", "--smoke", "--requests", "4",
         "--prompt-len", "32", "--gen", "8"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="int8 serving example")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    device = ap.parse_args(argv).device
    base = SMOKE + (["--device", device] if device else [])

    out_int8 = serve.main(base)
    out_fp = serve.main(base + ["--fp"])
    print(f"int8 vs bf16 generated-token agreement: "
          f"{float((out_int8 == out_fp).mean()):.2f}")

    # chunked prefill (4 chunks of 8) + nucleus sampling
    serve.main(base + ["--prefill-chunk", "8", "--temperature", "0.8",
                       "--top-p", "0.9"])

    # continuous batching: 6 ragged requests through 2 cache slots; the
    # printed program counts stay 1 however the queue drains
    serve.main(base + ["--requests", "6", "--max-slots", "2",
                       "--prefill-chunk", "8", "--block-steps", "4"])

    # speculative decoding: prompt-lookup drafts + one batched verify pass
    # per window over the int8 cache (greedy's tokens)
    serve.main(base + ["--max-slots", "2", "--prefill-chunk", "8",
                       "--strategy", "speculative", "--spec-k", "4",
                       "--spec-ngram", "2"])

    # int4 KV cache with distill-trained thresholds (paper §3)
    serve.main(base + ["--kv-bits", "4", "--finetune-thresholds", "1"])

    # the Engine facade + paged prefix sharing: three identical prompts
    # through a paged scheduler; the second and third admissions attach the
    # first one's shared pages and run no prefill
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.scheduler import Request

    engine = Engine.from_checkpoint("smollm-135m", smoke=True, device=device,
                                    cache_layout="paged", page_size=8,
                                    prefill_chunk=8)
    prompt = np.arange(1, 25, dtype=np.int32) % engine.cfg.vocab
    reqs = [Request(rid=r, tokens=prompt, max_gen=6) for r in range(3)]
    done = engine.generate(reqs, max_slots=2)
    sched = engine.make_scheduler(max_slots=2, prompt_cap=len(prompt),
                                  gen_cap=6)
    stats, calls = sched.prefix_stats(), sched.call_counts()
    print(f"[engine] paged prefix sharing: {len(done)} identical prompts, "
          f"{calls['prefill']} prefill call(s), {stats['hits']} hits, "
          f"{stats['shared_tokens']} prompt tokens reused")
    assert calls["prefill"] == 1 and stats["hits"] == 2
    assert len({tuple(c.tokens) for c in done}) == 1, \
        "identical prompts must generate identical tokens"


if __name__ == "__main__":
    main()
