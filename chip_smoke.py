#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero before the
last line):
  1. card   — CUDA device present; nvidia-smi name and power limit.
  2. build  — nvcc builds the kernels from src/repro_torch/kernels/csrc
              (ptxas registers, shared memory and spills printed).
  3. kernels — each kernel against its plain PyTorch version at yi-6b
              attention shapes (and head_dim 64, llama-te-mini), bf16
              and float32 pools: max abs error within its limit, kernel
              time (CUDA events), plain time, the time of PyTorch's
              scaled_dot_product_attention over the gathered view (a
              yardstick the port never calls) and the bound.
  4. forward — full-width 32-layer yi-6b (random bf16 weights, seed 0):
              a chunk_step and decode_steps through the kernels, every
              kernel call held against its plain version on the same
              inputs; the end-to-end logits against the plain path are
              printed (random weights make the 32-layer stack chaotic:
              a one-step rounding difference grows layer by layer).
  5. serve  — ChunkedServer on full-width yi-6b: a ShareGPT-like wave
              (paper Table XII protocol) and a shared-system-prompt
              wave (radix prefix cache + copy-on-write); every request
              complete at its expected length, both kernels launched.
  6. profile — wall and device time of a full-width decode step and
              chunk step, and the kernels that take the device time.
  7. small  — the reduced yi-6b served through the kernels on the card
              and through the plain versions on the CPU: equal token
              streams, except where the CPU's own top-2 margin is tiny.
Then one JSON line of per-kernel numbers and, last, the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# float32 pools: the kernel and the plain version sum in another order,
# a few float32 roundings of outputs of magnitude ~1
F32_LIMIT = 2e-5
# bf16 pools: p and the output are rounded to bf16, and a value on a
# rounding boundary may round the other way: one bf16 step at |o| < 4
BF16_LIMIT = 2e-2
# a kernel call of the full-width forward against its plain version on
# the same inputs: two bf16 steps (2**-6) of the output's magnitude
ATTN_REL_LIMIT = 2.0 ** -6
# small-input serving, card vs CPU: logits differ by a bf16 step or so
# (cuBLAS and the CPU round differently); streams may part where the
# top-2 margin is within four bf16 steps at |logit| < 4
SMALL_MARGIN = 0.0625
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
# 1-2. card and build
# ----------------------------------------------------------------------

def phase_card() -> dict:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, secs, log = build.compile_source("paged_attention.cu",
                                           ptxas_verbose=True)
    print(f"[build] {os.path.relpath(path, ROOT)} "
          f"{'built in %.1f s' % secs if secs else 'already built'}")
    for line in log.splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line
                                or "Compiling" in line):
            print(f"[build]   {line.strip()}")
    build.load("paged_attention.cu")
    print(f"[build] loaded in {time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------------------------------------
# 3. kernels against their plain versions
# ----------------------------------------------------------------------

def _time_ms(fn, iters: int, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case_inputs(dtype, B, H, KH, hd, bs, MB, C, seed):
    """Pool, block table with -1 tails, ragged lengths up to MB*bs."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    T = MB * bs
    NB = B * MB + 8
    kv = torch.tensor([T - 8, 1, 17, 100, T - 17, 33, 128, 200][:B],
                      dtype=torch.int32, device=DEVICE).clamp(1, T)
    ck = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    cv = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    bt = torch.randperm(NB, generator=g, device=DEVICE)[:B * MB]
    bt = bt.reshape(B, MB).to(torch.int32)
    nblk = (kv + bs - 1) // bs
    col = torch.arange(MB, device=DEVICE)[None, :]
    bt = torch.where(col < nblk[:, None], bt, torch.full_like(bt, -1))
    qd = torch.randn((B, 1, H, hd), generator=g, device=DEVICE).to(dtype)
    qc = torch.randn((B, C, H, hd), generator=g, device=DEVICE).to(dtype)
    pos = (kv - C).clamp(min=0)
    return qd, qc, ck, cv, bt, kv, pos


def _bound(kind, dtype_name, B, H, KH, hd, C, MB, bs, lens, elt):
    """Least time for the work: each input byte read once (q, the K/V
    rows the rows attend, table, lengths), output written once; 4*hd
    operations per (query head, attended position)."""
    lens = [int(x) for x in lens]
    T = MB * bs
    if kind == "decode":
        tokens = [min(n, T) for n in lens]
        pairs = sum(tokens)
        rows = 1
    else:
        tokens = [min(p + C, T) for p in lens]
        pairs = sum(min(p + 1 + i, T) for p in lens for i in range(C))
        rows = C
    kv_bytes = 2 * sum(tokens) * KH * hd * elt
    qo_bytes = 2 * B * rows * H * hd * elt
    nbytes = kv_bytes + qo_bytes + 4 * B * (MB + 1)
    ops = 4 * hd * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_inputs(q, ck, cv, bt, bound_rows):
    """Gathered view for scaled_dot_product_attention: q [B,H,R,hd],
    k/v repeated to H heads [B,H,T,hd], boolean mask [B,1,R,T]."""
    import torch
    from repro_torch.models import attention
    kg, vg = attention.gather_paged_cache(ck, cv, bt)
    H, KH = q.shape[2], ck.shape[2]
    k = kg.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    v = vg.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    T = k.shape[2]
    mask = (torch.arange(T, device=q.device)[None, None, None, :]
            < bound_rows[:, None, :, None])
    return q.transpose(1, 2).contiguous(), k, v, mask


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    cases = [
        # name, dtype, B, H, KH, hd, bs, MB
        ("yi-6b", torch.bfloat16, 8, 32, 4, 128, 16, 17),
        ("yi-6b", torch.float32, 8, 32, 4, 128, 16, 17),
        ("llama-te-mini", torch.bfloat16, 8, 12, 12, 64, 16, 17),
        ("llama-te-mini", torch.float32, 8, 12, 12, 64, 16, 17),
    ]
    C = 16
    results = {}
    for i, (name, dtype, B, H, KH, hd, bs, MB) in enumerate(cases):
        qd, qc, ck, cv, bt, kv, pos = _case_inputs(dtype, B, H, KH, hd, bs,
                                                   MB, C, seed=i)
        dname = str(dtype).replace("torch.", "")
        limit = BF16_LIMIT if dtype == torch.bfloat16 else F32_LIMIT
        ar = torch.arange(C, device=DEVICE, dtype=torch.int32)
        for kind in ("decode", "chunk"):
            if kind == "decode":
                q, lens = qd, kv
                kern = lambda: pk.paged_decode(q, ck, cv, bt, lens)
                plain = lambda: pk.paged_decode_plain(q, ck, cv, bt, lens)
                rows_bound = lens[:, None]
            else:
                q, lens = qc, pos
                kern = lambda: pk.paged_chunk(q, ck, cv, bt, lens)
                plain = lambda: pk.paged_chunk_plain(q, ck, cv, bt, lens)
                rows_bound = lens[:, None] + 1 + ar[None, :]
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got.float()).all():
                fail(f"{kind} {name} {dname}: non-finite kernel output")
            ms = _time_ms(kern, 200)
            plain_ms = _time_ms(plain, 10)
            sq, sk, sv, mask = _sdpa_inputs(q, ck, cv, bt, rows_bound)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), 50)
            bound_ms, bound_by = _bound(kind, dname, B, H, KH, hd, C, MB, bs,
                                        lens.tolist(), ck.element_size())
            ok = err <= limit
            print(f"[kernels] paged_{kind} {name} {dname} B={B} H={H} "
                  f"KH={KH} hd={hd} bs={bs} MB={MB}"
                  f"{' C=%d' % C if kind == 'chunk' else ''}: "
                  f"max_abs_err={err:.3e} (limit {limit:.0e}) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"sdpa_ms={lib_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"({bound_by}) {'ok' if ok else 'OVER LIMIT'}",
                  flush=True)
            if not ok:
                fail(f"paged_{kind} {name} {dname}: max abs error {err} "
                     f"over {limit}")
            results[(kind, name, dname)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    return results


# ----------------------------------------------------------------------
# 4. full-width forward, kernels against the plain gather path
# ----------------------------------------------------------------------

def _top2_margin(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_forward(cfg, params) -> None:
    """One chunk_step and `steps` decode_steps of full-width yi-6b
    through the kernels, every kernel call held against its plain
    version on the same inputs (the pool the call reads, its q); then
    the same steps through the plain path, for the end-to-end logits."""
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import api, transformer
    B, C, bs, steps = 4, 16, 16, 3
    MB = -(-264 // bs)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                           device=DEVICE, dtype=torch.int32)
    n_tok = torch.tensor([16, 9, 16, 3], dtype=torch.int32, device=DEVICE)
    bt = torch.full((B, MB), -1, dtype=torch.int32, device=DEVICE)
    bt[:, :2] = torch.arange(2 * B, dtype=torch.int32,
                             device=DEVICE).reshape(B, 2)
    calls = {"decode": [0, 0.0], "chunk": [0, 0.0]}   # count, worst ratio
    orig = transformer._cache_attend

    def checked(q, k1, v1, cl, pos, positions, block_table, *, decode,
                kernel):
        o = orig(q, k1, v1, cl, pos, positions, block_table,
                 decode=decode, kernel=kernel)
        if kernel:
            want = (pk.paged_decode_plain(q, cl["k"], cl["v"], block_table,
                                          pos + 1) if decode else
                    pk.paged_chunk_plain(q, cl["k"], cl["v"], block_table,
                                         pos)).float()
            err = (o.float() - want).abs().max().item()
            rec = calls["decode" if decode else "chunk"]
            rec[0] += 1
            rec[1] = max(rec[1], err / max(want.abs().max().item(), 1e-30))
        return o

    def run(kernel: bool):
        cache = api.init_cache(cfg, B, 264, block_size=bs,
                               num_blocks=B * MB, device=DEVICE)
        pos = torch.zeros(B, dtype=torch.int32, device=DEVICE)
        out = [api.chunk_step(cfg, params, cache, tokens, pos, n_tok, bt,
                              kernel=kernel)[0]]
        pos = n_tok.clone()
        for _ in range(steps):
            tok = out[-1].argmax(-1).to(torch.int32)
            out.append(api.decode_step(cfg, params, cache, tok, pos, bt,
                                       kernel=kernel)[0])
            pos = pos + 1
        return torch.stack(out)

    t0 = time.perf_counter()
    transformer._cache_attend = checked
    try:
        lk = run(True)
    finally:
        transformer._cache_attend = orig
    lp = run(False)
    torch.cuda.synchronize()
    worst = max(r[1] for r in calls.values())
    e2e = (lk.float() - lp.float()).abs().max().item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"[forward] yi-6b {cfg.num_layers} layers d={cfg.d_model}, B={B}:"
          f" 1 chunk_step + {steps} decode_steps; kernel calls vs plain on "
          f"the same inputs: {calls['chunk'][0]} chunk + "
          f"{calls['decode'][0]} decode, max |diff| / max |o| = "
          f"{worst:.3e} (limit {ATTN_REL_LIMIT:.3e}); end to end, kernel "
          f"path vs plain path (each feeding its own argmax): max |logit "
          f"diff| {e2e:.4f}, argmax agree {agree}/{lk.shape[0] * B} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not (torch.isfinite(lk.float()).all()
            and torch.isfinite(lp.float()).all()):
        fail("full-width forward gave non-finite logits")
    if calls["chunk"][0] != cfg.num_layers or \
            calls["decode"][0] != steps * cfg.num_layers:
        fail(f"the forward did not go through the kernels once per layer: "
             f"{calls}")
    if worst > ATTN_REL_LIMIT:
        fail(f"full-width kernel calls differ from the plain version by "
             f"{worst:.3e} of the output's magnitude (limit "
             f"{ATTN_REL_LIMIT:.3e})")


# ----------------------------------------------------------------------
# 5. serving
# ----------------------------------------------------------------------

def phase_serve(cfg, params) -> dict:
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.runtime.server import (ChunkedServer,
                                            sharegpt_like_requests,
                                            sysprompt_sharegpt_requests)
    max_input, max_output = 128, 128
    max_len = max_input + max_output + 8       # as the CLI sizes it
    srv = ChunkedServer(cfg, params, batch_slots=8, max_len=max_len,
                        chunk=16, span=8, block_size=16, prefix_cache=True,
                        device=DEVICE)
    waves = [
        ("sharegpt", sharegpt_like_requests(
            16, cfg.vocab_size, max_input=max_input,
            max_output=max_output, seed=0)),
        # template_len 72 is not block aligned: a shared template ends
        # mid-block, so admission maps it copy-on-write
        ("sysprompt", sysprompt_sharegpt_requests(
            16, cfg.vocab_size, num_templates=2, template_len=72,
            max_input=max_input, max_output=max_output, seed=1)),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()                  # main path starts here
    all_stats = []
    for name, reqs in waves:
        stats = srv.serve(reqs)
        all_stats.append((name, reqs, stats,
                          srv.metrics.counter_value("serving.cow.resolves")))
    launches = srv.launch_counts()            # main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, reqs, st, cow in all_stats:
        print(f"[serve] {name}: {int(st['requests'])} requests, "
              f"{int(st['tokens'])} tokens in {st['seconds']:.2f} s = "
              f"{st['tokens_per_s']:.1f} tok/s; prefill "
              f"{st['prefill_seconds']:.2f} s / {int(st['chunk_steps'])} "
              f"chunk steps ({int(st['prefill_tokens'])} tokens), decode "
              f"{st['decode_seconds']:.2f} s / {int(st['decode_spans'])} "
              f"spans ({int(st['decode_tokens'])} tokens); pool peak "
              f"{int(st['peak_blocks_in_use'])}/{int(st['pool_blocks'])} "
              f"blocks, stalls {int(st['admission_stalls'])}; prefix hits "
              f"{int(st['prefix_hit_requests'])}/{int(st['requests'])}, "
              f"cached tokens {int(st['prefix_cached_tokens'])}/"
              f"{int(st['prompt_tokens_total'])}, evictions "
              f"{int(st['cache_evictions'])}, cow resolves {cow}",
              flush=True)
        for r in reqs:
            want = min(r.max_new, max_len - len(r.prompt))
            if not r.done or len(r.output) != want:
                fail(f"{name} request {r.rid}: done={r.done}, "
                     f"{len(r.output)} tokens, expected {want}")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"{name} request {r.rid}: token out of vocab")
    print(f"[serve] peak memory {peak_gb:.2f} GB; launch counts "
          f"{launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    if all_stats[1][3] <= 0 or all_stats[1][2]["prefix_hit_requests"] <= 0:
        fail("the sysprompt wave hit no prefix / resolved no copy-on-write")
    return launches


# ----------------------------------------------------------------------
# 6. where the time goes
# ----------------------------------------------------------------------

def phase_profile(cfg, params) -> None:
    """Wall and device time of one full-width decode step and one chunk
    step (B=8, 128 cached tokens per slot) through the kernels, with
    the kernels that take the most device time (torch.profiler)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    B, bs, C, steps = 8, 16, 16, 5
    MB = -(-264 // bs)
    cache = api.init_cache(cfg, B, 264, block_size=bs, num_blocks=B * MB,
                           device=DEVICE)
    bt = torch.arange(B * MB, dtype=torch.int32,
                      device=DEVICE).reshape(B, MB)
    pos = torch.full((B,), 128, dtype=torch.int32, device=DEVICE)
    tok = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    toks = torch.zeros((B, C), dtype=torch.int32, device=DEVICE)
    n_tok = torch.full((B,), C, dtype=torch.int32, device=DEVICE)
    units = {
        "decode_step": lambda: api.decode_step(cfg, params, cache, tok, pos,
                                               bt, kernel=True),
        "chunk_step": lambda: api.chunk_step(cfg, params, cache, toks, pos,
                                             n_tok, bt, kernel=True),
    }
    for name, fn in units.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        by_name = collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = e.cuda_time_total
                by_name[e.name] += us / steps / 1e3
        dev = sum(by_name.values())
        top = "; ".join(f"{n[:48]} {ms:.2f}" for n, ms in
                        by_name.most_common(6))
        busy = (f"device {dev:.2f} ms ({dev / wall:.0%} busy); top kernels "
                f"(ms per step): {top}" if dev else
                "device time not measured (the profiler saw no kernel)")
        print(f"[profile] {name} B={B} kv=128: wall {wall:.2f} ms, {busy}",
              flush=True)


# ----------------------------------------------------------------------
# 7. served tokens against the plain path on a small input
# ----------------------------------------------------------------------

def _plain_logits(cfg, params, seq, device) -> "torch.Tensor":
    """Logits after `seq` through the plain gather path (batch 1)."""
    import torch
    from repro_torch.models import api
    C, bs = 8, 8
    MB = -(-len(seq) // bs) + 1
    cache = api.init_cache(cfg, 1, MB * bs, block_size=bs, num_blocks=MB,
                           device=device)
    bt = torch.arange(MB, dtype=torch.int32, device=device)[None]
    seq = torch.as_tensor(seq, dtype=torch.int32, device=device)
    for off in range(0, len(seq), C):
        chunk = seq[off:off + C]
        toks = torch.zeros((1, C), dtype=torch.int32, device=device)
        toks[0, :len(chunk)] = chunk
        logits, _ = api.chunk_step(
            cfg, params, cache, toks,
            torch.tensor([off], dtype=torch.int32, device=device),
            torch.tensor([len(chunk)], dtype=torch.int32, device=device),
            bt, kernel=False)
    return logits[0].float()


def phase_small() -> None:
    """The reduced yi-6b (2 layers, d_model 64, G=2) served through the
    kernels on the card and through the plain versions on the CPU, with
    the same weights: the token streams must be equal, except that a
    stream may part where the CPU path's own top-2 logit margin is
    within SMALL_MARGIN (two bf16 roundings apart can pick either)."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    from repro_torch.runtime.server import (ChunkedServer, clone_requests,
                                            sharegpt_like_requests)
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2)
    cpu_params = api.init(cfg, 0, device="cpu")

    def to(tree, device):
        if isinstance(tree, torch.Tensor):
            return tree.to(device)
        return {k: to(v, device) for k, v in tree.items()}

    reqs = sharegpt_like_requests(8, cfg.vocab_size, max_input=32,
                                  max_output=16, seed=0)
    outs = {}
    for device, params in (("cpu", cpu_params), (DEVICE, to(cpu_params,
                                                            DEVICE))):
        rs = clone_requests(reqs)
        ChunkedServer(cfg, params, batch_slots=4, max_len=56, chunk=8,
                      span=4, block_size=8, device=device).serve(rs)
        outs[device] = [r.output for r in rs]
    equal = parted = 0
    for r, a, b in zip(reqs, outs["cpu"], outs[DEVICE]):
        if a == b:
            equal += 1
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = _plain_logits(cfg, cpu_params,
                           list(r.prompt) + a[:j], "cpu")
        margin = float(_top2_margin(lg))
        if margin > SMALL_MARGIN or lg.max() - lg[b[j]] > SMALL_MARGIN:
            fail(f"small input, request {r.rid}: card and CPU part at "
                 f"token {j} where the CPU margin is {margin:.4f}")
        parted += 1
    print(f"[small] reduced yi-6b (G=2) card kernels vs CPU plain: "
          f"{equal}/{len(reqs)} token streams equal, {parted} part at a "
          f"top-2 margin within {SMALL_MARGIN}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    device = phase_card()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    phase_build()
    kernels = phase_kernels()
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[init] yi-6b full width, {cfg.param_count() / 1e9:.2f} B "
          f"params in bf16, {time.perf_counter() - t0:.1f} s", flush=True)
    phase_forward(cfg, params)
    launches = phase_serve(cfg, params)
    phase_profile(cfg, params)
    del params
    phase_small()
    line = []
    for kind, line_no in (("decode", 163), ("chunk", 252)):
        r = kernels[(kind, "yi-6b", "bfloat16")]
        line.append({
            "name": f"paged_{kind}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{line_no}",
            "launches": launches[f"paged_{kind}"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
