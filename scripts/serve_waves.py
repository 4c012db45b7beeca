#!/usr/bin/env python3
"""Served tokens/s of the port's ChunkedServer on full-width yi-6b, at
chip_smoke.py phase 5's settings: random bf16 weights (seed 0), 8 slots,
chunk 16, span 8, block 16, prefix cache, greedy; a ShareGPT-like wave
then a shared-system-prompt wave, 16 requests each (128 tokens in, 128
out).  A warm-up wave of other requests runs first, so that neither
timed wave pays the first call's set-up.

    PYTHONPATH=src python3 scripts/serve_waves.py [--fp8] [--sample-head]

--fp8 serves an e4m3 KV pool and fp8 linears.  --sample-head makes
every dispatch end in the sample head; the server ends a dispatch whose
slots are all greedy in the argmax instead, with the same tokens (a
tree without that choice takes no --sample-head).  The script imports
repro_torch from PYTHONPATH, so one copy of it times any tree of the
port (an A/B: PYTHONPATH=<other tree>/src); it prints the card's name
and power limit, then one line a wave.
"""

from __future__ import annotations

import argparse
import subprocess
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fp8", action="store_true")
    ap.add_argument("--sample-head", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime.server import (ChunkedServer,
                                            sharegpt_like_requests,
                                            sysprompt_sharegpt_requests)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = get_config("yi-6b")
    params = api.init(cfg, 0, device="cuda", dtype=torch.bfloat16)
    max_input, max_output = 128, 128
    srv = ChunkedServer(cfg, params, batch_slots=8,
                        max_len=max_input + max_output + 8, chunk=16,
                        span=8, block_size=16, prefix_cache=True,
                        fp8_kv=args.fp8, fp8_linear=args.fp8, device="cuda")
    if args.sample_head:
        srv._samp = srv._samp_operands
    srv.serve(sharegpt_like_requests(8, cfg.vocab_size, max_input=32,
                                     max_output=32, seed=100))
    waves = [
        ("sharegpt", sharegpt_like_requests(
            16, cfg.vocab_size, max_input=max_input,
            max_output=max_output, seed=0)),
        ("sysprompt", sysprompt_sharegpt_requests(
            16, cfg.vocab_size, num_templates=2, template_len=72,
            max_input=max_input, max_output=max_output, seed=1)),
    ]
    for name, reqs in waves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = srv.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"wave={name} fp8={args.fp8} sample_head={args.sample_head} "
              f"tokens={int(st['tokens'])} "
              f"seconds={dt:.4f} tokens_per_s={st['tokens'] / dt:.2f} "
              f"decode_seconds={st['decode_seconds']:.4f} "
              f"spans={int(st['decode_spans'])} "
              f"chunk_steps={int(st['chunk_steps'])}", flush=True)


if __name__ == "__main__":
    main()
