#!/usr/bin/env python3
"""B9's (flash attention's) time a call by the route a call takes to the
kernel, at chip_smoke.py phase 10(a)'s launch-bound shapes and two
compute-bound ones:

    wrapper    kernels.flash_attention.flash_attention_fwd: with no
               dispatch mode active, straight to the op's CUDA
               implementation
    dispatch   torch.ops.repro_torch.flash_attention_fwd: the same
               implementation through the dispatcher
    custom_op  the same implementation behind a Python
               torch.library.custom_op (defined here, used nowhere in
               the port)

Random bf16 inputs (seed 0); CUDA events around 50 back-to-back calls,
the routes interleaved over 3 rounds, each route's median ms printed.

    PYTHONPATH=src python3 scripts/b9_dispatch.py

It prints the card's name and power limit, then one line a shape.
"""

import statistics
import subprocess
from typing import Tuple

# name, B, Sq, Sk, H, KH, hd, causal (chip_smoke.py's FLASH_CASES)
CASES = (
    ("llama-te-mini", 2, 2048, 2048, 12, 12, 64, True),
    ("whisper-cross", 8, 448, 1500, 12, 12, 64, False),
    ("yi-6b-fsdp-tp-shard", 1, 4096, 4096, 8, 1, 128, True),
    ("moonshot-fsdp-tp-shard", 1, 2048, 2048, 4, 4, 128, True),
    ("whisper-dec-shard", 1, 448, 448, 3, 3, 64, True),
    ("whisper-cross-shard", 1, 448, 1500, 3, 3, 64, False),
    ("te-h8192", 4, 512, 512, 64, 64, 128, True),
    ("yi-6b", 2, 4096, 4096, 32, 4, 128, True),
)
ITERS, ROUNDS = 50, 3


def _time_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> None:
    import torch
    from repro_torch.kernels import flash_attention as kfa
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    @torch.library.custom_op("b9_dispatch::flash_attention_fwd",
                             mutates_args=(), device_types="cuda")
    def as_custom_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        return kfa._flash_cuda(q, k, v, causal, 0, 0, 512, 512)

    g = torch.Generator(device="cuda").manual_seed(0)
    for name, B, Sq, Sk, H, KH, hd, causal in CASES:
        q = torch.randn((B, Sq, H, hd), generator=g, device="cuda")
        k = torch.randn((B, Sk, KH, hd), generator=g, device="cuda")
        v = torch.randn((B, Sk, KH, hd), generator=g, device="cuda")
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        routes = {
            "wrapper": lambda: kfa.flash_attention_fwd(q, k, v,
                                                       causal=causal),
            "dispatch": lambda: torch.ops.repro_torch.flash_attention_fwd(
                q, k, v, causal, 0, 0, 512, 512),
            "custom_op": lambda: as_custom_op(q, k, v, causal),
        }
        ms = {r: [] for r in routes}
        for _ in range(ROUNDS):
            for r, fn in routes.items():
                ms[r].append(_time_ms(torch, fn))
        print(f"[b9_dispatch] {name} B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} "
              f"hd={hd} causal={causal}: " + ", ".join(
                  f"{r} {statistics.median(v):.4f} ms "
                  f"({' '.join(f'{x:.4f}' for x in v)})"
                  for r, v in ms.items()), flush=True)
        del q, k, v


if __name__ == "__main__":
    main()
