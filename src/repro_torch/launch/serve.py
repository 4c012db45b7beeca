"""Serving entry point of the port: ChunkedServer over an arch config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --requests 8 --slots 4

Serves the reduced (CPU-smoke-sized) config of ``--arch`` with random
weights from ``--seed``, on the CUDA device by default; ``--device cpu``
runs the same path with the kernels' plain versions.  ``--workload
sysprompt`` serves the shared-prefix mix and prints the radix prefix
cache's hit-rate stats; ``--no-prefix-cache`` turns the cache off.
``--fp8-kv`` stores the KV pool as e4m3 codes + per-row scales (read by
the fp8 kernels) and ``--fp8-linear`` serves the projections through
fp8-quantized weights.  ``--spec-decode K`` runs decode-only stretches
as speculative verify steps (n-gram drafts, one [slots, K+1] verify
through the paged chunk kernel a dispatch; the tokens of K=0) and
prints the acceptance stats; ``--workload repetitive`` serves the
tiled-motif mix on which the drafts hit.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import list_archs, reduced_config
from repro_torch.models import api
from repro_torch.runtime.server import (ChunkedServer, repetitive_requests,
                                        sharegpt_like_requests,
                                        sysprompt_sharegpt_requests)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=list_archs())
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size")
    ap.add_argument("--span", type=int, default=8,
                    help="device-resident decode steps per dispatch")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV tokens per paged-cache block")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged-cache pool size in blocks (default: "
                         "slots * ceil(max_len / block_size))")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the radix-tree prefix cache")
    ap.add_argument("--fp8-kv", action="store_true",
                    help="store the paged KV pool as fp8 e4m3 codes + "
                         "per-row f32 scales ((hd+4)/(2*hd) of the bf16 "
                         "pool's bytes), read by the fp8 kernels")
    ap.add_argument("--fp8-linear", action="store_true",
                    help="serve the projection/MLP matmuls through "
                         "fp8-quantized weights (te/linear)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a request when it emits this token id; "
                         "default: length-only stopping")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: draft up to K tokens per "
                         "slot from a device-resident n-gram table and "
                         "verify them in one dispatch through the paged "
                         "chunk kernel, accepting the longest prefix "
                         "that matches the model's own chain (the tokens "
                         "of K=0).  Default 0 = off (decode spans)")
    ap.add_argument("--workload", default="sharegpt",
                    choices=("sharegpt", "sysprompt", "repetitive"),
                    help="sharegpt: log-normal independent prompts; "
                         "sysprompt: shared system-prompt templates x "
                         "unique tails (exercises prefix sharing); "
                         "repetitive: tiled-motif prompts (high n-gram "
                         "hit rate, exercises --spec-decode)")
    ap.add_argument("--templates", type=int, default=2,
                    help="number of shared templates (sysprompt) / "
                         "motifs (repetitive)")
    ap.add_argument("--max-input", type=int, default=32)
    ap.add_argument("--max-output", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch)
    if cfg.family != "dense":
        raise SystemExit(f"{args.arch} ({cfg.family}): only the dense "
                         "family is ported")
    params = api.init(cfg, args.seed, device=args.device)
    max_len = args.max_input + args.max_output + 8
    srv = ChunkedServer(cfg, params, batch_slots=args.slots,
                        max_len=max_len, chunk=args.chunk, span=args.span,
                        block_size=args.block_size,
                        num_blocks=args.pool_blocks,
                        prefix_cache=not args.no_prefix_cache,
                        eos_id=args.eos_id, spec_decode=args.spec_decode,
                        fp8_kv=args.fp8_kv, fp8_linear=args.fp8_linear,
                        device=args.device)
    if args.workload == "repetitive":
        reqs = repetitive_requests(args.requests, cfg.vocab_size,
                                   num_motifs=args.templates,
                                   motif_len=max(args.max_input // 4, 1),
                                   reps=4, max_output=args.max_output,
                                   seed=args.seed)
    elif args.workload == "sysprompt":
        if args.max_input < 2:
            raise SystemExit(
                "--workload sysprompt needs --max-input >= 2 (a shared "
                "template prefix plus at least one unique tail token)")
        reqs = sysprompt_sharegpt_requests(
            args.requests, cfg.vocab_size, num_templates=args.templates,
            template_len=max(args.max_input // 2, 1),
            max_input=args.max_input, max_output=args.max_output,
            seed=args.seed)
    else:
        reqs = sharegpt_like_requests(args.requests, cfg.vocab_size,
                                      max_input=args.max_input,
                                      max_output=args.max_output,
                                      seed=args.seed)
    stats = srv.serve(reqs)
    print(f"arch={args.arch} device={srv.device} "
          f"workload={args.workload} "
          f"fp8_kv={args.fp8_kv} fp8_linear={args.fp8_linear} "
          f"requests={int(stats['requests'])} "
          f"tokens={int(stats['tokens'])} "
          f"throughput={stats['tokens_per_s']:.1f} tok/s "
          f"(paper Table XII protocol)")
    print(f"  prefill={stats['prefill_seconds']:.2f}s/"
          f"{int(stats['chunk_steps'])}d "
          f"decode={stats['decode_seconds']:.2f}s/"
          f"{int(stats['decode_spans'])}d "
          f"kernel_launches={srv.launch_counts()}")
    print(f"  paged-kv: {int(stats['peak_blocks_in_use'])}/"
          f"{int(stats['pool_blocks'])} blocks peak "
          f"(x{int(stats['block_size'])} tokens, "
          f"utilization={stats['pool_utilization']:.2f}, "
          f"stalls={int(stats['admission_stalls'])})")
    if "spec_k" in stats:
        print(f"  spec-decode: K={int(stats['spec_k'])} "
              f"accepted={int(stats['spec_accepted_tokens'])}/"
              f"{int(stats['spec_drafted_tokens'])} drafts "
              f"(rate={stats['spec_acceptance_rate']:.2f}), "
              f"{stats['spec_tokens_per_step']:.2f} tokens/step "
              f"over {int(stats['spec_steps'])} verify dispatches")
    if "prefix_cache_enabled" in stats:
        print(f"  prefix-cache: hit-rate="
              f"{stats['prefix_hit_rate']:.2f} "
              f"({int(stats['prefix_hit_requests'])}/"
              f"{int(stats['requests'])} requests), "
              f"cached-token-frac={stats['cached_token_fraction']:.2f} "
              f"({int(stats['prefix_cached_tokens'])}/"
              f"{int(stats['prompt_tokens_total'])} prompt tokens), "
              f"resident={int(stats['cached_blocks'])} blocks, "
              f"evictions={int(stats['cache_evictions'])}")
    return stats


if __name__ == "__main__":
    main()
