"""Serving entry point of the port: continuous-batching server over an
arch config.

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
tiled-motif mix on which the drafts hit.  ``--contiguous`` serves the
contiguous per-slot KV layout instead of the paged pool, and ``--engine
slot`` the slot baseline (token-at-a-time prefill, a host read every
decode step).  ``--arch`` takes the dense, moe (e.g. moonshot-v1-16b-a3b,
dbrx-132b; ``--fp8-linear`` refused) and vlm (internvl2-1b) archs.

``--arrival-rate R`` switches from the closed batch to open-loop
serving: requests arrive on a Poisson stream at R req/s
(runtime/arrivals) and queue delay is charged from arrival.
``--duration S`` sizes the stream to ~R*S requests; ``--slo-ttft-ms``
/ ``--slo-tpot-ms`` (always together) score the run against latency
deadlines and print the attainment / goodput / windowed-throughput
summary (obs/slo, obs/windows).  All of it composes with
``--trace/--trace-out``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arrival-rate 4 \\
        --duration 5 --slo-ttft-ms 500 --slo-tpot-ms 80 \\
        --trace --trace-out <prefix>
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import list_archs, reduced_config
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import api
from repro_torch.obs import (SLOSpec, Tracer, slo_report, summary_table,
                             window_series, window_summary,
                             write_chrome_trace, write_jsonl)
from repro_torch.runtime.arrivals import poisson_stream
from repro_torch.runtime.server import (ChunkedServer, SlotServer,
                                        repetitive_requests,
                                        sharegpt_like_requests,
                                        sysprompt_sharegpt_requests)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=list_archs())
    ap.add_argument("--engine", default="chunked",
                    choices=("chunked", "slot"),
                    help="chunked-prefill scheduler (default) or the "
                         "slot baseline")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size (chunked engine)")
    ap.add_argument("--span", type=int, default=8,
                    help="device-resident decode steps per dispatch "
                         "(chunked engine)")
    ap.add_argument("--contiguous", action="store_true",
                    help="use the contiguous per-slot KV layout instead "
                         "of the paged block pool (chunked engine)")
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
    ap.add_argument("--arrival-rate", type=float, default=None,
                    metavar="RPS",
                    help="serve open-loop: Poisson request arrivals at "
                         "RPS req/s against the monotonic clock "
                         "(chunked engine; queue delay and TTFT are "
                         "charged from arrival).  Default: closed "
                         "batch, all requests at t=0")
    ap.add_argument("--duration", type=float, default=None, metavar="S",
                    help="with --arrival-rate, size the stream to "
                         "~rate*S requests (~S seconds of offered "
                         "traffic) instead of --requests")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT deadline in ms; with --slo-tpot-ms, "
                         "score the run's SLO attainment and goodput "
                         "(obs/slo; implies --trace)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="TPOT deadline in ms (mean inter-token time "
                         "after the first); see --slo-ttft-ms")
    ap.add_argument("--trace", action="store_true",
                    help="record per-request lifecycle events and "
                         "dispatch timings (repro_torch.obs) and print "
                         "the latency/phase/occupancy summary table; "
                         "host-side only (chunked engine)")
    ap.add_argument("--trace-out", metavar="PREFIX", default=None,
                    help="with --trace, also write PREFIX.jsonl "
                         "(structured events) and PREFIX.trace.json "
                         "(Chrome trace-event format, Perfetto-"
                         "loadable)")
    args = ap.parse_args(argv)

    if (args.slo_ttft_ms is None) != (args.slo_tpot_ms is None):
        raise SystemExit("--slo-ttft-ms and --slo-tpot-ms go together "
                         "(the SLO predicate needs both deadlines)")
    if args.duration is not None and args.arrival_rate is None:
        raise SystemExit("--duration needs --arrival-rate (it sizes "
                         "the open-loop stream)")
    if args.arrival_rate is not None and args.engine != "chunked":
        raise SystemExit("--arrival-rate needs the chunked engine "
                         "(the slot baseline has no open-loop path)")
    if args.slo_ttft_ms is not None:
        args.trace = True   # attainment is scored off the tracer
    if args.trace and args.engine != "chunked":
        raise SystemExit("--trace needs the chunked engine (the slot "
                         "baseline is not instrumented)")
    if args.engine == "slot":
        if args.spec_decode:
            raise SystemExit("--spec-decode needs the chunked engine "
                             "(the slot baseline has no verify path)")
        if args.fp8_kv or args.fp8_linear:
            raise SystemExit("--fp8-kv/--fp8-linear need the chunked "
                             "engine's paged pool")
    if args.contiguous and args.fp8_kv:
        raise SystemExit("--fp8-kv needs the paged pool (drop "
                         "--contiguous)")
    if args.duration is not None:
        args.requests = max(1, round(args.arrival_rate * args.duration))

    cfg = reduced_config(args.arch)
    try:
        params = api.init(cfg, args.seed, device=args.device)
        max_len = args.max_input + args.max_output + 8
        tracer = Tracer() if args.trace else None
        if args.engine == "chunked":
            srv = ChunkedServer(cfg, params, batch_slots=args.slots,
                                max_len=max_len, chunk=args.chunk,
                                span=args.span, paged=not args.contiguous,
                                block_size=args.block_size,
                                num_blocks=args.pool_blocks,
                                prefix_cache=not args.no_prefix_cache,
                                eos_id=args.eos_id,
                                spec_decode=args.spec_decode,
                                fp8_kv=args.fp8_kv,
                                fp8_linear=args.fp8_linear,
                                tracer=tracer, device=args.device)
        else:
            srv = SlotServer(cfg, params, batch_slots=args.slots,
                             max_len=max_len, eos_id=args.eos_id,
                             device=args.device)
    except NotImplementedError as e:
        # an unported family, or fp8 linears with moe
        raise SystemExit(f"{args.arch} ({cfg.family}): {e}")
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
    if args.arrival_rate is not None:
        stats = srv.serve_online(poisson_stream(reqs, args.arrival_rate,
                                                seed=args.seed))
    else:
        stats = srv.serve(reqs)
    print(f"arch={args.arch} engine={args.engine} device={srv.device} "
          f"workload={args.workload} "
          f"fp8_kv={args.fp8_kv} fp8_linear={args.fp8_linear} "
          f"requests={int(stats['requests'])} "
          f"tokens={int(stats['tokens'])} "
          f"throughput={stats['tokens_per_s']:.1f} tok/s "
          f"(paper Table XII protocol)")
    if args.arrival_rate is not None:
        print(f"  open-loop: target={args.arrival_rate:.2f} req/s "
              f"offered={stats['offered_rate_rps']:.2f} req/s over "
              f"{stats['arrival_span_s']:.2f}s of arrivals, "
              f"peak-queue-depth={int(stats['peak_queue_depth'])}, "
              f"idle={stats['idle_s']:.2f}s of {stats['seconds']:.2f}s")
    counts = srv.compile_counts()
    per_program = " ".join(f"{name}={n}"
                           for name, n in sorted(counts.items()))
    if args.engine == "chunked":
        print(f"  prefill={stats['prefill_seconds']:.2f}s/"
              f"{int(stats['chunk_steps'])}d "
              f"decode={stats['decode_seconds']:.2f}s/"
              f"{int(stats['decode_spans'])}d "
              f"compiled_programs={sum(counts.values())} ({per_program}) "
              f"kernel_launches={pk.launch_counts()}")
    else:
        print(f"  prefill={stats['prefill_seconds']:.2f}s "
              f"decode={stats['decode_seconds']:.2f}s "
              f"compiled_programs={sum(counts.values())} ({per_program}) "
              f"kernel_launches={pk.launch_counts()}")
    if "pool_blocks" in stats:
        print(f"  paged-kv: {int(stats['peak_blocks_in_use'])}/"
              f"{int(stats['pool_blocks'])} blocks peak "
              f"(x{int(stats['block_size'])} tokens, "
              f"utilization={stats['pool_utilization']:.2f}, "
              f"stalls={int(stats['admission_stalls'])}, "
              f"capacity {int(stats['kv_tokens_capacity'])} vs "
              f"{int(stats['kv_tokens_contiguous'])} contiguous tokens)")
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
    if tracer is not None:
        print(summary_table(tracer))
        window_s = max(stats["seconds"] / 8.0, 0.02)
        if args.slo_ttft_ms is not None:
            slo = SLOSpec(ttft_s=args.slo_ttft_ms / 1e3,
                          tpot_s=args.slo_tpot_ms / 1e3)
            rep = slo_report(tracer, slo, stats["seconds"])
            wsum = window_summary(window_series(tracer, window_s))
            tps = wsum["tokens_per_s"]
            print(f"  slo: ttft<={args.slo_ttft_ms:.0f}ms "
                  f"tpot<={args.slo_tpot_ms:.0f}ms -> "
                  f"attainment={rep['attainment']:.2%} "
                  f"({rep['met']}/{rep['finished']} met, "
                  f"{rep['ttft_misses']} ttft / "
                  f"{rep['tpot_misses']} tpot misses)")
            print(f"  goodput: {rep['goodput_tok_s']:.1f} of "
                  f"{rep['throughput_tok_s']:.1f} tok/s from SLO-met "
                  f"requests ({int(rep['good_tokens'])}/"
                  f"{int(rep['finished_tokens'])} output tokens)")
            print(f"  windowed({window_s * 1e3:.0f}ms x "
                  f"{wsum['n_windows']}): tok/s p50={tps['p50']:.1f} "
                  f"p95={tps['p95']:.1f} p99={tps['p99']:.1f}, "
                  f"peak-queue-depth={wsum['peak_queue_depth']}, "
                  f"stalls={wsum['stalls']}")
        if args.trace_out:
            n = write_jsonl(tracer, f"{args.trace_out}.jsonl")
            m = write_chrome_trace(tracer, f"{args.trace_out}.trace.json",
                                   window_s=window_s)
            print(f"  wrote {args.trace_out}.jsonl ({n} lines), "
                  f"{args.trace_out}.trace.json ({m} events)")
    return stats


if __name__ == "__main__":
    main()
