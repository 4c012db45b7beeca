"""LLM serving loop with continuous batching (paper §III-C-3 analog).

PyTorch counterpart of ``ChunkedServer`` in ``repro/runtime/server.py``:
Sarathi-style chunked prefill packs prompt chunks and the single-token
decodes of ongoing requests into one fixed-shape [slots, chunk] step
(`models.api.chunk_step`); decode-only stretches run a device-resident
`span`-step decode loop (sample head, position advance, active-slot
masking and stop detection all on the device), or with
``spec_decode=K`` one verify step a dispatch (runtime/spec_decode.py:
n-gram drafts scored in one [slots, K+1] `api.verify_step`); the host
mirrors the deterministic bookkeeping in numpy and reads tokens only
when it harvests finished requests (or every step when ``eos_id`` is
set; a verify step's acceptance is always read back).

Every work unit ends in the sample head (models/sampling.py): per-slot
temperature / top-k / top-p / seed mirrors, filled at admission from
``Request.sampling`` or the server's default (greedy unless
``sampling=`` is given), and a draw keyed by (seed, emission position),
so the chunk, span and verify paths draw the same token for the same
position.  Greedy is a value, not another code path: a greedy row is
the argmax, chosen inside the head.

Each work unit (chunk step, decode span, verify step, copy-on-write
copy) is one `runtime.graphs.WorkUnit`: on the card its first call runs
eagerly, its second is captured into one CUDA graph, and every later
call replays it, with the scheduler's operands copied into static
buffers; `compile_counts()` reports the units' programs under the
reference's keys, one each once used, whatever the lengths and the
greedy/sampled mix.  On the CPU the units run eagerly through the same
buffers and count the same way.

The KV cache is a paged block pool with per-slot block tables, a
refcounted allocator with admission backpressure, and a radix-tree
prefix cache whose shared blocks are copied on write
(`api.cow_copy_block`) — all host-side, as in the reference.
``paged=False`` restores the reference's contiguous layout for A/B: one
``max_len + chunk`` region a slot, no pool, no prefix cache and no
copy-on-write unit; the work units take a dummy [slots, 1] block table
so their operands keep one signature, and read the cache through the
plain attention (as the reference's, whose kernels need a table).  On
the CPU, where the paged kernels run their plain versions, both layouts
give the same greedy tokens (masked positions weigh exactly 0).

Every work unit of the paged layout reads the pool through the
hand-written CUDA kernels of kernels/paged_attention.py
(``kernel=True``; for CPU tensors the wrappers compute their plain
versions).  The kernels agree with the plain gather path to float32
rounding, not bitwise: they sum in another order, so a bf16 value on a
rounding boundary may round the other way (tolerances in
kernels/paged_attention.py).  Greedy tokens
can therefore differ from the gather path where two logits are within
that rounding of each other.

``fp8_kv=True`` stores the pool as e4m3 codes plus one float32 scale
per token row per kv head, (hd+4)/(2*hd) of the bf16 pool's bytes,
read by the fp8 kernels; ``fp8_linear=True`` quantizes every layer
weight to e4m3 once at init (te/linear.quantize_serving_params) and
serves each projection through te/linear.fp8_serving_dot.  Both change
numerics within fp8 rounding, as in the reference.

``serve_online`` serves an open-loop stream (runtime/arrivals.py):
requests are released to the admission queue when the clock passes
their arrival stamps, and their queue delay and TTFT are charged from
the arrival.

``SlotServer`` is the reference's measured baseline: prefill steps one
token at a time through `decode_step` (one work unit a distinct prompt
length), and every decode step reads its argmax back to the host.

Both servers serve the transformer families, as the reference's: dense,
moe (its MLP is `models/moe.moe_mlp` over each unit's whole window,
padding rows included, so one request's tokens depend on what is
batched with it, as in the reference) and vlm.  ``fp8_linear`` with
moe raises ``NotImplementedError``, as the reference refuses it.

Not ported yet: tensor parallelism; passing ``tp`` or ``mesh`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as pk
from repro_torch.models import api, sampling
from repro_torch.models.common import resolve_device
from repro_torch.models.sampling import GREEDY, SamplingParams
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.runtime import spec_decode as spec
from repro_torch.runtime.graphs import WorkUnit
from repro_torch.runtime.prefix_cache import BlockPool, RadixPrefixCache
from repro_torch.te import linear as te_linear

Params = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [in_len] int32
    max_new: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set at admission when in_len + max_new overruns the max_len
    # position cap: generation will stop at max_len - in_len tokens
    truncated: bool = False
    # per-request sampling config (models/sampling.SamplingParams);
    # None falls back to the server's default
    sampling: Optional[SamplingParams] = None


def sharegpt_like_requests(n: int, vocab: int, *, max_input: int = 128,
                           max_output: int = 128, seed: int = 0
                           ) -> List[Request]:
    """Log-normal length mix approximating the ShareGPT distribution
    (the same draws as the reference for the same seed)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        in_len = int(np.clip(rng.lognormal(3.2, 0.8), 4, max_input))
        out_len = int(np.clip(rng.lognormal(3.5, 0.7), 4, max_output))
        prompt = rng.integers(0, vocab, size=in_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=out_len))
    return reqs


def sysprompt_sharegpt_requests(n: int, vocab: int, *,
                                num_templates: int = 2,
                                template_len: int = 64,
                                max_input: int = 128,
                                max_output: int = 128, seed: int = 0
                                ) -> List[Request]:
    """Shared-prefix serving mix: N fixed system-prompt templates, each
    request one template plus a log-normal unique tail (the same draws
    as the reference for the same seed)."""
    assert template_len < max_input
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, vocab, size=template_len).astype(np.int32)
                 for _ in range(num_templates)]
    reqs = []
    for i in range(n):
        t = templates[int(rng.integers(num_templates))]
        tail_len = int(np.clip(rng.lognormal(2.0, 0.8), 1,
                               max_input - template_len))
        out_len = int(np.clip(rng.lognormal(3.5, 0.7), 4, max_output))
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=np.concatenate([t, tail]),
                            max_new=out_len))
    return reqs


def repetitive_requests(n: int, vocab: int, *, num_motifs: int = 2,
                        motif_len: int = 8, reps: int = 3,
                        max_output: int = 48, seed: int = 0
                        ) -> List[Request]:
    """Highly repetitive mix: each prompt tiles one of a few short
    motifs, so identical requests recur within and across waves — the
    n-gram draft proposer's best case (the same draws as the reference
    for the same seed)."""
    rng = np.random.default_rng(seed)
    motifs = [rng.integers(0, vocab, size=motif_len).astype(np.int32)
              for _ in range(num_motifs)]
    reqs = []
    for i in range(n):
        motif = motifs[int(rng.integers(num_motifs))]
        reqs.append(Request(rid=i, prompt=np.tile(motif, reps),
                            max_new=max_output))
    return reqs


def clone_requests(reqs: List[Request]) -> List[Request]:
    """Fresh Request objects for re-serving the same mix (A/B runs)."""
    return [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                    sampling=r.sampling)
            for r in reqs]


# ----------------------------------------------------------------------
# Chunked-prefill engine
# ----------------------------------------------------------------------

class ChunkedServer:
    """Chunked-prefill continuous-batching server (transformer families).

    Work units, plain functions on device tensors:
      * chunk step  — [slots, chunk] tokens; prefilling slots consume up
        to `chunk` prompt tokens, decoding slots piggyback their next
        token at row 0.
      * decode span — `span` consecutive decode steps on the device
        when no prefill is pending, with no host read inside.
      * verify step — with ``spec_decode=K``, decode-only stretches run
        one [slots, K+1] speculative window a dispatch instead: n-gram
        drafts verified against the model's own chain (the K=0 tokens,
        >= 1 token per slot per dispatch).
      * copy-on-write copy — one pool block into another, every layer
        (paged only).
    Each is a `WorkUnit` (one CUDA graph on the card; `compile_counts`).

    The host mirrors position/emission bookkeeping in numpy — greedy
    decoding with length-only stopping is deterministic, so the mirror
    never reads device state; with ``eos_id`` set the span's final
    pos/out_len/active state is read back instead.  With the paged pool
    (default), `_ensure_blocks` assigns physical blocks as a slot's
    frontier advances, `_admit` reserves a request's worst case minus
    its prefix-cache hit and backpressures when the pool cannot hold
    it, and `_harvest` drops the slot's references.  ``paged=False``
    keeps one contiguous ``max_len + chunk`` region a slot instead.  The
    cache is updated in place.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 batch_slots: int = 8, max_len: int = 512,
                 chunk: int = 16, span: int = 8, paged: bool = True,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 eos_id: Optional[int] = None,
                 spec_decode: int = 0,
                 spec_n_ctx: int = spec.DEFAULT_N_CTX,
                 fp8_kv: bool = False,
                 fp8_linear: bool = False, tp: int = 1, mesh=None,
                 sampling: Optional[SamplingParams] = None,
                 tracer: Optional[Tracer] = None, device=None):
        deferred = {"tp": tp != 1, "mesh": mesh is not None}
        for name, on in deferred.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        if spec_decode < 0:
            raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
        if fp8_kv and not paged:
            raise ValueError("fp8_kv requires the paged KV pool (paged=True)")
        if spec_decode and not paged and spec_decode >= chunk:
            # the contiguous cache's + chunk headroom must absorb the
            # verify window's writes past the frontier (paged scatters
            # drop them past the block table)
            raise ValueError(
                "spec_decode window (K+1) must fit the chunk headroom")
        api.check_family(cfg)
        if fp8_linear and cfg.family == "moe":
            # the reference refuses it too (its fp8 linears quantize the
            # dense MLP's weights only)
            raise NotImplementedError(
                "fp8_linear serving is dense/vlm-only for now")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.fp8_kv = bool(fp8_kv)
        # fp8_linear is tp=1 and dense/vlm only, as in the reference
        # (tp is not ported, checked above)
        self._quant = (te_linear.quantize_serving_params(params)
                       if fp8_linear else None)
        self.B = batch_slots
        self.max_len = max_len
        self.chunk = chunk
        self.span = span
        self.paged = bool(paged)
        self.eos_id = eos_id
        # the default for requests without their own SamplingParams;
        # greedy is a value (temperature 0), not another code path
        self.sampling = sampling if sampling is not None else GREEDY
        self.spec_decode = int(spec_decode)
        # host-side observability: `self.obs` records lifecycle events
        # only when a Tracer is passed; `self.metrics` is always a real
        # registry, so the per-phase breakdown exists untraced too
        self.obs = tracer if tracer is not None else NULL_TRACER
        self.metrics = (tracer.metrics if tracer is not None
                        else MetricsRegistry())
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if self.paged:
            self.block_size = block_size
            # virtual blocks per slot; real writes never pass max_len
            self.max_blocks = -(-max_len // block_size)
            self.num_blocks = (batch_slots * self.max_blocks
                               if num_blocks is None else num_blocks)
            self.cache = api.init_cache(cfg, batch_slots, max_len,
                                        block_size=block_size,
                                        num_blocks=self.num_blocks,
                                        device=self.device,
                                        fp8_kv=self.fp8_kv)
            self.block_table = np.full((batch_slots, self.max_blocks), -1,
                                       np.int32)
            self.pool = BlockPool(self.num_blocks)
            if prefix_cache:
                self.prefix_cache = RadixPrefixCache(self.pool, block_size,
                                                     tracer=self.obs,
                                                     metrics=self.metrics)
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(batch_slots)]
            self._num_shared = np.zeros(batch_slots, np.int32)
            self._cow_pending = [False] * batch_slots
            self._reserved = np.zeros(batch_slots, np.int32)
            self._reserved_total = 0
            self.peak_blocks = 0
            self.admission_stalls = 0
            self.total_prompt_tokens = 0
            self.cached_prompt_tokens = 0
            self.prefix_hits = 0
        else:
            # + chunk headroom: chunk and verify writes start at the
            # valid frontier and must never clamp (attention.update_cache)
            self.cache = api.init_cache(cfg, batch_slots, max_len + chunk,
                                        paged=False, device=self.device)
            # the work units' block-table operand: a dummy, so their
            # operand signatures do not vary with the layout
            self.block_table = np.zeros((batch_slots, 1), np.int32)
        # device-resident state: tokens cross to the host only at harvest
        self.cur_tok = torch.zeros(batch_slots, dtype=torch.int32,
                                   device=self.device)
        self.out_buf = torch.zeros((batch_slots, max_len), dtype=torch.int32,
                                   device=self.device)
        self._rows = torch.arange(batch_slots, device=self.device)
        # host-owned mirror (deterministic; never read back from the
        # device unless eos stopping is on)
        self.pos = np.zeros(batch_slots, np.int32)
        self.out_len = np.zeros(batch_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.mode = ["idle"] * batch_slots    # idle | prefill | decode | done
        self.prompt_off = np.zeros(batch_slots, np.int32)
        # per-slot sampling mirrors (filled at admission; idle slots
        # hold greedy values, so they never draw)
        self.samp_temp = np.zeros(batch_slots, np.float32)
        self.samp_top_k = np.zeros(batch_slots, np.int32)
        self.samp_top_p = np.ones(batch_slots, np.float32)
        self.samp_seed = np.zeros(batch_slots, np.int32)
        if self.spec_decode:
            # shared by every slot, kept across runs (warm drafts)
            self.ngram_table = spec.init_ngram_table(
                self.spec_decode, spec_n_ctx, device=self.device)
            self.spec_steps = 0
            self.spec_slot_steps = 0
            self.spec_drafted = 0
            self.spec_accepted = 0
            self.spec_emitted = 0
        self._units = self._make_units()
        if self.obs.enabled:
            # server geometry next to the events: the roofline view
            # (obs/views.roofline_efficiency) prices each recorded
            # decode dispatch through core/roofline with these
            self.obs.meta.update(
                batch_slots=self.B, chunk=self.chunk, span=self.span,
                max_len=self.max_len, num_layers=cfg.num_layers,
                kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                spec_decode=self.spec_decode, tp=1, paged=self.paged)
            if self.paged:
                self.obs.meta.update(
                    block_size=self.block_size, max_blocks=self.max_blocks,
                    num_blocks=self.num_blocks,
                    kv_read_mode="fp8_kernel" if self.fp8_kv else "kernel")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _samp_mirrors(self) -> Tuple[np.ndarray, ...]:
        """The sample head's per-slot operands (host mirrors)."""
        return (self.samp_temp, self.samp_top_k, self.samp_top_p,
                self.samp_seed)

    def launch_counts(self) -> Dict[str, int]:
        """Launches of the paged-attention kernels in this process (the
        wrappers' counts, bf16 and fp8 bodies, replays included; CPU runs
        launch none)."""
        return pk.launch_counts()

    def compile_counts(self) -> Dict[str, int]:
        """Programs per work unit, under the reference's keys: one
        operand signature each once used (0 before), so O(1) whatever
        the lengths and the greedy/sampled mix; on the card each unit
        with two calls or more is one captured CUDA graph.
        ``cow_copy`` is 0 until the first copy-on-write and exists with
        the paged pool only, and ``verify_step`` exists with spec decode
        only."""
        return {name: unit.programs for name, unit in self._units.items()}

    # -- device work units ------------------------------------------------
    def _make_units(self) -> Dict[str, WorkUnit]:
        """The work units, sharing one graph memory pool on the card (they
        never run at once)."""
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        bodies = {"chunk_step": self._chunk_body,
                  "decode_span": self._span_body}
        if self.paged:
            bodies["cow_copy"] = self._cow_body
        if self.spec_decode:
            bodies["verify_step"] = self._spec_body
        return {name: WorkUnit(name, body, self.device, pool=pool,
                               counted=pk.KERNELS)
                for name, body in bodies.items()}

    def _chunk_body(self, tokens_host, pos, n_tokens, is_decode, emit,
                    out_len, temp, top_k, top_p, seed, block_table
                    ) -> Tuple[torch.Tensor, ...]:
        C = tokens_host.shape[1]
        col0 = torch.arange(C, device=self.device) == 0
        tokens = torch.where(is_decode[:, None] & col0[None, :],
                             self.cur_tok[:, None], tokens_host)
        logits, _ = api.chunk_step(
            self.cfg, self.params, self.cache, tokens, pos, n_tokens,
            block_table if self.paged else None, kernel=self.paged,
            quant=self._quant)
        # the emitted token sits at position pos + n_tokens: the key of
        # the span and verify paths' draw for the same position
        nxt = sampling.sample_tokens(logits, temp, top_k, top_p, seed,
                                     pos + n_tokens)
        self.cur_tok.copy_(torch.where(emit, nxt, self.cur_tok))
        idx = out_len.long().clamp(0, self.max_len - 1)
        self.out_buf[self._rows, idx] = torch.where(
            emit, nxt, self.out_buf[self._rows, idx])
        return ()

    def _span_body(self, pos, out_len, active, max_new, temp, top_k, top_p,
                   seed, block_table) -> Tuple[torch.Tensor, ...]:
        cap = self.max_len - 1
        tok = self.cur_tok
        bt = block_table if self.paged else None
        for _ in range(self.span):
            logits, _ = api.decode_step(
                self.cfg, self.params, self.cache, tok, pos, bt,
                kernel=self.paged, quant=self._quant)
            # emission position pos + 1 (before the increment)
            nxt = sampling.sample_tokens(logits, temp, top_k, top_p, seed,
                                         pos + 1)
            idx = out_len.long().clamp(0, self.max_len - 1)
            self.out_buf[self._rows, idx] = torch.where(
                active, nxt, self.out_buf[self._rows, idx])
            inc = active.to(torch.int32)
            out_len = out_len + inc
            pos = pos + inc
            tok = torch.where(active, nxt, tok)
            active = active & (out_len < max_new) & (pos < cap)
            if self.eos_id is not None:
                # the EOS token itself is emitted, then the slot stops
                active = active & (nxt != self.eos_id)
        self.cur_tok.copy_(tok)
        return pos, out_len, active

    def _spec_body(self, pos, out_len, active, max_new, temp, top_k, top_p,
                   seed, block_table) -> Tuple[torch.Tensor, ...]:
        (_, table, cur_tok, _, pos, out_len, active,
         n_emit) = spec.spec_decode_step(
            self.cfg, self.params, self.cache, self.ngram_table,
            self.cur_tok, self.out_buf, pos, out_len, active, max_new,
            temp, top_k, top_p, seed,
            block_table if self.paged else None, max_len=self.max_len,
            eos_id=self.eos_id,
            fwd_kw={"kernel": self.paged, "quant": self._quant})
        self.ngram_table.copy_(table)
        self.cur_tok.copy_(cur_tok)
        return pos, out_len, active, n_emit

    def _cow_body(self, src, dst) -> Tuple[torch.Tensor, ...]:
        api.cow_copy_block(self.cfg, self.cache, src, dst)
        return ()

    # -- host-side refcounted block allocator -----------------------------
    def _blocks_needed(self, req: Request) -> int:
        """Worst-case block demand: the frontier never passes
        min(in_len + max_new, max_len)."""
        span_len = min(len(req.prompt) + req.max_new, self.max_len)
        return -(-span_len // self.block_size)

    def _available_blocks(self) -> int:
        """Blocks admission may still promise: free + evictable cached,
        minus reservations already outstanding."""
        ev = (self.prefix_cache.evictable_blocks()
              if self.prefix_cache is not None else 0)
        return self.pool.num_free() + ev - self._reserved_total

    def _blocks_in_use(self) -> int:
        """Working set: blocks pinned or owned by a request (refcount-0
        tree residue is reclaimable and reported as ``cached_blocks``)."""
        in_use = self.num_blocks - self.pool.num_free()
        if self.prefix_cache is not None:
            in_use -= self.prefix_cache.evictable_blocks()
        return in_use

    def _reclaim(self, n: int) -> None:
        """Grow the free list to >= n blocks with ONE LRU eviction sweep."""
        deficit = n - self.pool.num_free()
        if deficit > 0:
            assert self.prefix_cache is not None, "block pool over-committed"
            freed = self.prefix_cache.evict(deficit)
            assert freed >= deficit, \
                "block pool over-committed (nothing evictable)"

    def _take_block(self) -> int:
        """One owned block (refcount 1), evicting when the list is dry."""
        self._reclaim(1)
        return self.pool.alloc()

    def _match_prefix(self, prompt: np.ndarray
                      ) -> Tuple[List[int], Optional[int], int]:
        """Radix lookup, capped so at least the last prompt token is
        recomputed (its logits seed generation).  Returns (shared full
        blocks, copy-on-write block, matched tokens inside it)."""
        full, partial, plen = self.prefix_cache.match(prompt)
        bs = self.block_size
        usable = max(min(len(full) * bs + plen, len(prompt) - 1), 0)
        nfull = usable // bs
        cow_len = usable - nfull * bs
        if cow_len < max(bs // 2, 1):
            # a short partial overlap isn't worth a block copy
            return full[:nfull], None, 0
        cow = full[nfull] if nfull < len(full) else partial
        return full[:nfull], cow, cow_len

    def _ensure_blocks(self, s: int, upto: int) -> None:
        """Assign physical blocks so slot s covers virtual [0, upto),
        resolving a pending copy-on-write before the write frontier
        reaches the shared block."""
        bs = self.block_size
        owned = self._slot_blocks[s]
        need = -(-upto // bs)
        cow_now = (self._cow_pending[s]
                   and upto > int(self._num_shared[s]) * bs)
        self._reclaim(max(need - len(owned), 0) + bool(cow_now))
        if cow_now:
            ci = int(self._num_shared[s])
            src = owned[ci]
            dst = self._take_block()
            self._units["cow_copy"].run(np.array([src], np.int64),
                                        np.array([dst], np.int64))
            self.block_table[s, ci] = dst
            owned[ci] = dst
            self.pool.decref(src)
            self._reserved[s] -= 1
            self._reserved_total -= 1
            self._cow_pending[s] = False
            self.metrics.counter("serving.cow.resolves").inc()
            if self.obs.enabled:
                self.obs.event("cow_resolve", slot=int(s), src=int(src),
                               dst=int(dst))
        assert need - len(owned) <= self._reserved[s], \
            f"slot {s}: demand {need} blocks exceeds reservation"
        while len(owned) < need:
            b = self._take_block()
            self.block_table[s, len(owned)] = b
            owned.append(b)
            self._reserved[s] -= 1
            self._reserved_total -= 1
        in_use = self._blocks_in_use()
        self.peak_blocks = max(self.peak_blocks, in_use)
        self.metrics.gauge("serving.pool.blocks_in_use").set(float(in_use))

    def _truncate_blocks(self, s: int, upto: int) -> int:
        """Roll slot s's block-table frontier back so it owns exactly the
        blocks covering virtual [0, upto): the rollback after a verify
        step rejects drafts.  Blocks wholly past the frontier return to
        the pool and their reservation is restored.  Shared prefix
        blocks and a pending copy-on-write sit below the frontier, so
        refcounts are untouched.  Returns the blocks rolled back."""
        owned = self._slot_blocks[s]
        keep = -(-upto // self.block_size)
        assert keep >= int(self._num_shared[s]) + bool(self._cow_pending[s])
        freed = 0
        while len(owned) > keep:
            b = owned.pop()
            self.block_table[s, len(owned)] = -1
            self.pool.decref(b)
            self._reserved[s] += 1
            self._reserved_total += 1
            freed += 1
        return freed

    def _free_slot_blocks(self, s: int) -> None:
        """free == decref: cached blocks stay resident (evictable),
        exclusively-owned blocks return to the free list."""
        for b in self._slot_blocks[s]:
            self.pool.decref(b)
        self._slot_blocks[s] = []
        self._num_shared[s] = 0
        self._cow_pending[s] = False
        self.block_table[s, :] = -1
        self._reserved_total -= int(self._reserved[s])
        self._reserved[s] = 0

    # -- host-side scheduling --------------------------------------------
    def _admit_blocks(self, s: int, req: Request) -> Optional[int]:
        """Map the request's prefix-cache hit into slot s's block table
        and reserve its worst case minus the hit against the pool.
        Returns the prompt tokens the hit covers, or None when the pool
        cannot hold the request yet (backpressure: the queue head
        waits for a harvest)."""
        matched = 0
        shared: List[int] = []
        cow, cow_len = None, 0
        # cheap lower bound first: when even a fully-cached
        # prompt could not admit, skip the radix walk
        best_shared = (max((len(req.prompt) - 1) // self.block_size, 0)
                       if self.prefix_cache is not None else 0)
        fail_fast = (self._blocks_needed(req) - best_shared
                     > self._available_blocks())
        if not fail_fast and self.prefix_cache is not None:
            shared, cow, cow_len = self._match_prefix(req.prompt)
            # pin the hit before the supply check
            for b in shared:
                self.pool.incref(b)
            if cow is not None:
                self.pool.incref(cow)
            matched = len(shared) * self.block_size + cow_len
        # worst case minus the cache-covered prefix
        needed = self._blocks_needed(req) - len(shared)
        if cow is not None and needed > self._available_blocks():
            # tight supply: drop the partial match and recompute
            # its < block_size tokens rather than stall
            self.pool.decref(cow)
            cow, cow_len = None, 0
            matched = len(shared) * self.block_size
        if fail_fast or needed > self._available_blocks():
            for b in shared:        # roll the pin back
                self.pool.decref(b)
            if cow is not None:
                self.pool.decref(cow)
            if not any(r is not None for r in self.slot_req):
                raise ValueError(
                    f"request {req.rid}: needs "
                    f"{self._blocks_needed(req)} KV blocks "
                    f"but the pool has {self.num_blocks}; "
                    f"grow num_blocks")
            # backpressure: wait for a harvest to free blocks
            self.admission_stalls += 1
            self.metrics.counter("serving.admission.stalls").inc()
            if self.obs.enabled:
                self.obs.event("stall", rid=req.rid,
                               needed_blocks=needed)
            return None
        self._reserved[s] = needed
        self._reserved_total += needed
        self._slot_blocks[s] = list(shared)
        for i, b in enumerate(shared):
            self.block_table[s, i] = b
        self._num_shared[s] = len(shared)
        self._cow_pending[s] = cow is not None
        if cow is not None:
            self.block_table[s, len(shared)] = cow
            self._slot_blocks[s].append(cow)
        self.total_prompt_tokens += len(req.prompt)
        self.cached_prompt_tokens += matched
        self.prefix_hits += matched > 0
        return matched

    def _admit(self, queue: List[Request]) -> None:
        for s in range(self.B):
            if self.slot_req[s] is None and queue:
                req = queue[0]
                if len(req.prompt) > self.max_len:
                    queue.pop(0)
                    raise ValueError(
                        f"request {req.rid}: prompt length "
                        f"{len(req.prompt)} exceeds max_len {self.max_len}")
                matched = 0
                if self.paged:
                    matched = self._admit_blocks(s, req)
                    if matched is None:
                        break
                queue.pop(0)
                req.truncated = len(req.prompt) + req.max_new > self.max_len
                self.slot_req[s] = req
                self.mode[s] = "prefill"
                # chunked prefill resumes at the first uncached token
                self.prompt_off[s] = matched
                self.pos[s] = matched
                self.out_len[s] = 0
                # the request's sampling, or the server default
                sp = (req.sampling if req.sampling is not None
                      else self.sampling)
                self.samp_temp[s] = sp.temperature
                self.samp_top_k[s] = sp.top_k
                self.samp_top_p[s] = sp.top_p
                self.samp_seed[s] = sp.seed
                self.metrics.counter("serving.requests.admitted").inc()
                if self.obs.enabled:
                    self.obs.admit(req.rid, s, matched, req.truncated)
                    if matched:
                        self.obs.event("prefix_match", rid=req.rid,
                                       slot=s, matched_tokens=matched)

    def _check_done(self, s: int) -> None:
        # stop rule, applied after every emit (including the first token)
        req = self.slot_req[s]
        if (self.out_len[s] >= req.max_new
                or self.pos[s] >= self.max_len - 1):
            self._mark_done(s)

    def _mark_done(self, s: int) -> None:
        self.mode[s] = "done"
        if self.obs.enabled:
            req = self.slot_req[s]
            if req is not None:
                self.obs.finish(req.rid, int(self.out_len[s]))

    def _run_chunk_step(self) -> int:
        """One packed step: prefill chunks + piggybacked decodes."""
        t0 = time.perf_counter()
        B, C = self.B, self.chunk
        tokens_host = np.zeros((B, C), np.int32)
        n_tokens = np.zeros(B, np.int32)
        is_decode = np.zeros(B, bool)
        emit = np.zeros(B, bool)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.mode[s] == "prefill":
                off = int(self.prompt_off[s])
                n = min(C, len(req.prompt) - off)
                tokens_host[s, :n] = req.prompt[off:off + n]
                n_tokens[s] = n
                emit[s] = off + n == len(req.prompt)
                if self.paged:
                    self._ensure_blocks(s, int(self.pos[s]) + n)
            elif self.mode[s] == "decode":
                n_tokens[s] = 1
                is_decode[s] = True
                emit[s] = True
                if self.paged:
                    self._ensure_blocks(s, int(self.pos[s]) + 1)
        self._units["chunk_step"].run(
            tokens_host, self.pos, n_tokens, is_decode, emit, self.out_len,
            *self._samp_mirrors(), self.block_table)
        self._sync()
        t1 = time.perf_counter()
        packed = int(n_tokens.sum())
        self.metrics.counter("serving.dispatches.prefill").inc()
        self.metrics.histogram("serving.wall_s.prefill").record(t1 - t0)
        self.metrics.histogram("serving.chunk.occupancy").record(
            packed / (B * C) if B * C else 0.0)
        if self.obs.enabled:
            self.obs.span("chunk_dispatch", t0, t1,
                          packed_tokens=packed,
                          n_prefill=int((n_tokens > 0).sum()
                                        - is_decode.sum()),
                          n_decode=int(is_decode.sum()))
        # EOS needs the emitted tokens on the host; length-only stopping
        # reads nothing back
        toks = (self.cur_tok.cpu().numpy() if self.eos_id is not None
                else None)
        prompt_tokens = 0
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.mode[s] == "prefill":
                n = int(n_tokens[s])
                prompt_tokens += n
                self.prompt_off[s] += n
                self.pos[s] += n
                if emit[s]:                 # prompt exhausted: first token
                    self.mode[s] = "decode"
                    self.out_len[s] += 1
                    if self.obs.enabled:
                        self.obs.first_token(req.rid)
                    if toks is not None and int(toks[s]) == self.eos_id:
                        self._mark_done(s)
                    else:
                        self._check_done(s)
            elif self.mode[s] == "decode":
                self.out_len[s] += 1
                self.pos[s] += 1
                if toks is not None and int(toks[s]) == self.eos_id:
                    self._mark_done(s)
                else:
                    self._check_done(s)
        return prompt_tokens

    def _run_decode_span(self) -> None:
        t0 = time.perf_counter()
        active = np.array([m == "decode" for m in self.mode])
        if self.obs.enabled:
            kv_lens = tuple(int(p) for p in self.pos[active])
        max_new = np.array(
            [r.max_new if r is not None else 0 for r in self.slot_req],
            np.int32)
        # deterministic mirror of the device span, computed up front so
        # the allocator knows each slot's final frontier before the
        # device writes to it (EOS may stop a slot earlier than the sim
        # — that only over-assigns blocks within the reservation)
        cap = self.max_len - 1
        sim_pos = self.pos.copy()
        sim_out = self.out_len.copy()
        sim_act = active.copy()
        for _ in range(self.span):
            for s in np.flatnonzero(sim_act):
                sim_out[s] += 1
                sim_pos[s] += 1
                if sim_out[s] >= max_new[s] or sim_pos[s] >= cap:
                    sim_act[s] = False
        if self.paged:
            for s in np.flatnonzero(active):
                self._ensure_blocks(s, int(sim_pos[s]))
        pos_d, out_d, act_d = self._units["decode_span"].run(
            self.pos, self.out_len, active, max_new, *self._samp_mirrors(),
            self.block_table)
        self._sync()
        t1 = time.perf_counter()
        prev_out = self.out_len
        if self.eos_id is None:
            self.pos = sim_pos
            self.out_len = sim_out
            done_now = active & ~sim_act
        else:
            # EOS stopping is data-dependent: read the span's final
            # bookkeeping instead of trusting the length-only sim
            self.pos = pos_d.cpu().numpy().astype(np.int32)
            self.out_len = out_d.cpu().numpy().astype(np.int32)
            done_now = active & ~act_d.cpu().numpy()
        productive = int((self.out_len - prev_out).sum())
        self.metrics.counter("serving.dispatches.span").inc()
        self.metrics.histogram("serving.wall_s.span").record(t1 - t0)
        self.metrics.histogram("serving.span.utilization").record(
            productive / (self.B * self.span))
        if self.obs.enabled:
            self.obs.span("span_dispatch", t0, t1, steps=self.span,
                          n_active=int(active.sum()),
                          emitted=productive, kv_lens=kv_lens)
        for s in np.flatnonzero(done_now):
            self._mark_done(s)

    def _run_spec_step(self) -> None:
        """One draft -> verify -> accept step for every decoding slot
        (runtime/spec_decode.py).  Acceptance is data-dependent, so the
        final pos/out_len/active and the emitted counts are read back
        every step; the block tables are then rolled back to each
        slot's accepted frontier (the contiguous layout rolls back the
        position mirror alone: rejected rows sit past the frontier, in
        the chunk headroom, where the next window writes first)."""
        t0 = time.perf_counter()
        K = self.spec_decode
        active = np.array([m == "decode" for m in self.mode])
        if self.obs.enabled:
            kv_lens = tuple(int(p) for p in self.pos[active])
        max_new = np.array(
            [r.max_new if r is not None else 0 for r in self.slot_req],
            np.int32)
        cap = self.max_len - 1
        if self.paged:
            for s in np.flatnonzero(active):
                # cover the window only up to the slot's emit budget:
                # rows past it are never accepted and their writes drop
                # past the table, so the admission reservation suffices
                budget = min(int(max_new[s]) - int(self.out_len[s]),
                             cap - int(self.pos[s]))
                self._ensure_blocks(
                    s, int(self.pos[s]) + min(K + 1, max(budget, 1)))
        pos_d, out_d, act_d, emit_d = self._units["verify_step"].run(
            self.pos, self.out_len, active, max_new, *self._samp_mirrors(),
            self.block_table)
        emit = emit_d.cpu().numpy()
        self.pos = pos_d.cpu().numpy().astype(np.int32)
        self.out_len = out_d.cpu().numpy().astype(np.int32)
        done_now = active & ~act_d.cpu().numpy()
        t1 = time.perf_counter()
        # rejected drafts: shrink each frontier back to the accepted
        # positions (stale K/V past it is never read)
        if self.paged:
            for s in np.flatnonzero(active):
                rolled = self._truncate_blocks(s, int(self.pos[s]))
                if rolled:
                    self.metrics.counter(
                        "serving.spec.rollback_blocks").inc(rolled)
                    if self.obs.enabled:
                        self.obs.event("spec_rollback", slot=int(s),
                                       blocks=rolled)
        for s in np.flatnonzero(done_now):
            self._mark_done(s)
        nact = int(active.sum())
        emitted = int(emit.sum())
        accepted = int(np.maximum(emit - 1, 0).sum())
        self.spec_steps += 1
        self.spec_slot_steps += nact
        self.spec_drafted += K * nact
        self.spec_emitted += emitted
        self.spec_accepted += accepted
        spec.record_dispatch(
            self.metrics, self.obs, t0=t0, t1=t1, k=K, n_active=nact,
            emitted=emitted, accepted=accepted,
            kv_lens=kv_lens if self.obs.enabled else ())

    def _harvest(self) -> int:
        done_slots = [s for s in range(self.B) if self.mode[s] == "done"]
        if not done_slots:
            return 0
        # gather only the finished slots' rows before the host copy
        rows = self.out_buf.index_select(
            0, torch.as_tensor(done_slots, device=self.device)
        ).cpu().numpy()
        served = 0
        for i, s in enumerate(done_slots):
            req = self.slot_req[s]
            req.output = [int(t) for t in rows[i, : int(self.out_len[s])]]
            req.done = True
            served += len(req.prompt) + len(req.output)
            self.metrics.counter("serving.requests.harvested").inc()
            if self.obs.enabled:
                self.obs.finish(req.rid, len(req.output))
                self.obs.event("harvest", rid=req.rid, slot=s,
                               n_out=len(req.output))
            self.slot_req[s] = None
            self.mode[s] = "idle"
            if self.paged:
                if self.prefix_cache is not None:
                    self._insert_prefix(s, req)
                self._free_slot_blocks(s)
        return served

    def _insert_prefix(self, s: int, req: Request) -> None:
        """Feed the finished request's full-block prefix back into the
        radix tree (before the decrefs of `_free_slot_blocks`).  The
        last output token never has KV written, so the run covers
        positions [0, in_len + out_len - 1)."""
        assert not self._cow_pending[s], \
            f"slot {s}: unresolved copy-on-write at harvest"
        run = np.concatenate(
            [req.prompt, np.asarray(req.output[:-1], np.int32)])
        nfull = len(run) // self.block_size
        if nfull:
            self.prefix_cache.insert(run[:nfull * self.block_size],
                                     self._slot_blocks[s][:nfull])

    # -- main loop ---------------------------------------------------------
    def _reset_run_counters(self) -> None:
        """Per-run metric and pool state, shared by ``serve`` and
        ``serve_online`` (the tracer's event log accumulates across runs
        until the caller clears it)."""
        self.metrics.reset()
        if self.paged:
            self.peak_blocks = self._blocks_in_use()
            self.admission_stalls = 0
            self.total_prompt_tokens = 0
            self.cached_prompt_tokens = 0
            self.prefix_hits = 0
            self._evict0 = (self.prefix_cache.evicted_blocks
                            if self.prefix_cache is not None else 0)
        if self.spec_decode:
            # per run too (the n-gram table persists: warm drafts)
            self.spec_steps = 0
            self.spec_slot_steps = 0
            self.spec_drafted = 0
            self.spec_accepted = 0
            self.spec_emitted = 0

    def serve(self, requests: List[Request]) -> Dict[str, float]:
        """Serve a closed batch: every request queued at the start."""
        self._reset_run_counters()
        if self.obs.enabled:
            for r in requests:
                self.obs.enqueue(r.rid, len(r.prompt), r.max_new)
        return self._serve_loop(list(requests), [])

    def serve_online(self, stream, *,
                     max_idle_sleep_s: float = 0.02) -> Dict[str, float]:
        """Open-loop serving: admit by arrival time against a monotonic
        clock (runtime/arrivals.py streams).

        ``stream`` is a sequence of ``TimedRequest``-shaped objects
        (``.t_arrival`` seconds from the loop epoch, ``.request`` a
        ``Request``).  The epoch is ``time.perf_counter()`` at entry; a
        request is released to the admission queue once the clock
        passes its stamp, so the engine runs under sustained, bursty
        load instead of a pre-loaded batch.  Between dispatches the
        loop polls arrivals again, and when it is drained with arrivals
        still pending it sleeps (on the host, at most
        ``max_idle_sleep_s`` at a time) toward the next stamp.

        The tracer's enqueue stamp is the request's scheduled arrival
        (epoch + t_arrival), not the moment the loop saw it: a request
        arriving mid-dispatch is charged its queue delay, and so its
        TTFT, from its arrival.  Everything else is ``serve``'s loop
        (`_serve_loop`): the same work units (compile counts unchanged),
        the same host mirrors, and on a ``closed_stream`` the same
        admission order and tokens as ``serve`` on the same requests.

        Returns the ``serve`` stats plus the online extras: ``online``,
        ``arrival_span_s``, the realized ``offered_rate_rps``,
        ``idle_s`` and ``peak_queue_depth`` (also kept live in the
        ``serving.queue.depth`` gauge for the windowed views)."""
        arrivals = sorted(stream, key=lambda tr: tr.t_arrival)
        self._reset_run_counters()
        return self._serve_loop([], arrivals, max_idle_sleep_s)

    def _serve_loop(self, queue: List[Request], arrivals: list,
                    max_idle_sleep_s: Optional[float] = None
                    ) -> Dict[str, float]:
        """The scheduler loop of both: release the arrivals whose stamp
        the clock has passed, admit, run one dispatch, harvest.
        ``max_idle_sleep_s`` None is the closed batch (``queue`` holds
        every request, no arrivals, no online extras)."""
        online = max_idle_sleep_s is not None
        requests = queue + [tr.request for tr in arrivals]
        served_tokens = 0
        prefill_tokens = 0
        idle_s = 0.0
        peak_queue_depth = 0
        next_i = 0
        t0 = time.perf_counter()
        while (next_i < len(arrivals) or queue
               or any(r is not None for r in self.slot_req)):
            if online:
                now = time.perf_counter() - t0
                while (next_i < len(arrivals)
                       and arrivals[next_i].t_arrival <= now):
                    tr = arrivals[next_i]
                    next_i += 1
                    queue.append(tr.request)
                    if self.obs.enabled:
                        self.obs.enqueue(tr.request.rid,
                                         len(tr.request.prompt),
                                         tr.request.max_new,
                                         t=t0 + tr.t_arrival)
                peak_queue_depth = max(peak_queue_depth, len(queue))
                self.metrics.gauge("serving.queue.depth").set(
                    float(len(queue)))
            self._admit(queue)
            if any(m == "prefill" for m in self.mode):
                prefill_tokens += self._run_chunk_step()
            elif any(m == "decode" for m in self.mode):
                if self.spec_decode:
                    self._run_spec_step()
                else:
                    self._run_decode_span()
            elif not queue and next_i < len(arrivals):
                # drained with arrivals still scheduled: sleep toward
                # the next stamp instead of spinning
                wait = (t0 + arrivals[next_i].t_arrival
                        - time.perf_counter())
                if wait > 0:
                    nap = min(wait, max_idle_sleep_s)
                    time.sleep(nap)
                    idle_s += nap
            served_tokens += self._harvest()
        dt = time.perf_counter() - t0
        stats = self._run_stats(requests, dt, served_tokens, prefill_tokens)
        if online:
            span_s = arrivals[-1].t_arrival if arrivals else 0.0
            stats.update({
                "online": 1.0,
                "arrival_span_s": float(span_s),
                "offered_rate_rps": (len(arrivals) / span_s
                                     if span_s > 0 else 0.0),
                "idle_s": idle_s,
                "peak_queue_depth": float(peak_queue_depth),
            })
        return stats

    def _run_stats(self, requests: List[Request], dt: float,
                   served_tokens: int, prefill_tokens: int
                   ) -> Dict[str, float]:
        m = self.metrics
        chunk_steps = m.counter_value("serving.dispatches.prefill")
        span_disp = m.counter_value("serving.dispatches.span")
        verify_disp = m.counter_value("serving.dispatches.verify")
        span_s = m.hist_total("serving.wall_s.span")
        verify_s = m.hist_total("serving.wall_s.verify")
        stats = {
            "requests": float(len(requests)),
            "tokens": float(served_tokens),
            "seconds": dt,
            "tokens_per_s": served_tokens / dt if dt > 0 else 0.0,
            "prefill_seconds": m.hist_total("serving.wall_s.prefill"),
            "decode_seconds": span_s + verify_s,
            "verify_seconds": verify_s,
            "prefill_tokens": float(prefill_tokens),
            "decode_tokens": float(sum(len(r.output) for r in requests)),
            "decode_steps": float(span_disp * self.span),
            "chunk_steps": float(chunk_steps),
            "decode_spans": float(span_disp + verify_disp),
            "compiled_programs": float(sum(self.compile_counts().values())),
            "tp": 1.0,
        }
        if self.spec_decode:
            stats.update({
                "spec_k": float(self.spec_decode),
                "spec_steps": float(self.spec_steps),
                "spec_drafted_tokens": float(self.spec_drafted),
                "spec_accepted_tokens": float(self.spec_accepted),
                "spec_acceptance_rate": (
                    self.spec_accepted / self.spec_drafted
                    if self.spec_drafted else 0.0),
                # mean emitted tokens per slot per verify dispatch; the
                # span loop's equivalent is exactly 1.0
                "spec_tokens_per_step": (
                    self.spec_emitted / self.spec_slot_steps
                    if self.spec_slot_steps else 0.0),
            })
        if not self.paged:
            return stats
        contiguous_tokens = self.B * (self.max_len + self.chunk)
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in self.cache.values())
        stats.update({
            "pool_blocks": float(self.num_blocks),
            "block_size": float(self.block_size),
            "peak_blocks_in_use": float(self.peak_blocks),
            "pool_utilization": (self.peak_blocks / self.num_blocks
                                 if self.num_blocks else 0.0),
            "kv_tokens_capacity": float(self.num_blocks * self.block_size),
            "kv_tokens_contiguous": float(contiguous_tokens),
            "admission_stalls": float(self.admission_stalls),
            "kv_bytes_per_device": float(kv_bytes),
        })
        if self.prefix_cache is not None:
            total = self.total_prompt_tokens
            stats.update({
                "prefix_cache_enabled": 1.0,
                "prompt_tokens_total": float(total),
                "prefix_cached_tokens": float(self.cached_prompt_tokens),
                "cached_token_fraction": (
                    self.cached_prompt_tokens / total if total else 0.0),
                "prefix_hit_requests": float(self.prefix_hits),
                "prefix_hit_rate": (self.prefix_hits / len(requests)
                                    if requests else 0.0),
                "cache_evictions": float(
                    self.prefix_cache.evicted_blocks - self._evict0),
                "cached_blocks": float(
                    self.prefix_cache.cached_block_count()),
            })
        return stats


# ----------------------------------------------------------------------
# Baseline slot engine (the reference's seed engine, kept for A/B)
# ----------------------------------------------------------------------

class SlotServer:
    """Slot-based continuous-batching decode server: the baseline that
    the reference reports beside ChunkedServer.

    Prefill steps one token at a time through `decode_step`, one
    program a distinct prompt length; the decode loop reads its argmax
    back to the host every step.  That host read is what the baseline
    measures, and it stays.  The cache is contiguous ([max_len] a slot,
    read by the plain attention), as in the reference.  With the
    reference's two fixes over its seed: `pos0` is a real prefill
    operand (see `_prefill_body`), and the first emitted token is
    stop-checked, so max_new is honored even at 1.  ``eos_id`` stops a
    slot after it emits that token (ChunkedServer's rule).

    Each program is a `runtime.graphs.WorkUnit`: ``decode_step`` one
    unit, ``prefill_one`` one unit a distinct prompt length (its first
    call eager, its second captured into a CUDA graph, later calls
    replayed), so `compile_counts()` equals the reference's on the same
    traffic.  The server's position mirror lives on the host: the
    reference keeps it on the device and reads it back at every stop
    check, and both hold the same values.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 batch_slots: int = 8, max_len: int = 512,
                 eos_id: Optional[int] = None, device=None):
        api.check_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = api.init_cache(cfg, batch_slots, max_len, paged=False,
                                    device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._decode = self._unit("decode_step", self._decode_body)
        self._prefill: Dict[int, WorkUnit] = {}

    def _unit(self, name: str, body) -> WorkUnit:
        return WorkUnit(name, body, self.device, pool=self._pool,
                        counted=pk.KERNELS)

    # -- device work units ------------------------------------------------
    def _decode_body(self, tok, pos) -> Tuple[torch.Tensor, ...]:
        logits, _ = api.decode_step(self.cfg, self.params, self.cache, tok,
                                    pos)
        return (logits,)

    def _prefill_body(self, prompt, slot_onehot, pos0
                      ) -> Tuple[torch.Tensor, ...]:
        """Prefill one prompt into one slot by stepping its tokens
        through `decode_step` (every slot steps; the others write token
        0 at their own frontier, which their next step overwrites).

        `pos0` (the per-slot positions at admission) must be a real
        operand: the reference's seed closed over its position state,
        which jit froze as a constant per prompt length, so every later
        admission with an already-seen length replayed stale positions
        and wrote garbage at position 0 of the other slots' caches, and
        outputs depended on what else was in flight.  A captured graph
        would freeze it the same way; here it comes through the unit's
        static operand buffer, refilled every call."""
        pos = pos0
        for i in range(prompt.shape[0]):
            token_b = torch.where(slot_onehot > 0, prompt[i],
                                  torch.zeros_like(prompt[i]))
            logits, _ = api.decode_step(self.cfg, self.params, self.cache,
                                        token_b, pos)
            pos = pos + slot_onehot
        return (logits,)

    # -- admission -------------------------------------------------------
    def admit(self, req: Request, slot: int) -> torch.Tensor:
        """Prefill `req` into `slot`; returns its last prompt position's
        logits [vocab] on the device."""
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds max_len {self.max_len}")
        # ChunkedServer's truncation rule: the pos cap limits
        # generation to max_len - in_len tokens
        req.truncated = len(req.prompt) + req.max_new > self.max_len
        in_len = len(req.prompt)
        onehot = np.zeros(self.B, np.int32)
        onehot[slot] = 1
        self.pos[slot] = 0
        unit = self._prefill.get(in_len)
        if unit is None:
            unit = self._prefill[in_len] = self._unit(
                f"prefill_one[{in_len}]", self._prefill_body)
        (logits,) = unit.run(np.asarray(req.prompt, np.int32), onehot,
                             self.pos)
        self.pos[slot] = in_len
        self.slot_req[slot] = req
        return logits[slot]

    def compile_counts(self) -> Dict[str, int]:
        """One decode program + one prefill program per distinct prompt
        length, under the reference's keys."""
        return {"decode_step": self._decode.programs,
                "prefill_one": sum(u.programs
                                   for u in self._prefill.values())}

    def _stopped(self, req: Request, slot: int, tok: int) -> bool:
        return (len(req.output) >= req.max_new
                or int(self.pos[slot]) >= self.max_len - 1
                or (self.eos_id is not None and tok == self.eos_id))

    # -- main loop ---------------------------------------------------------
    def serve(self, requests: List[Request]) -> Dict[str, float]:
        queue = list(requests)
        next_tok = np.zeros(self.B, np.int32)
        t0 = time.perf_counter()
        served_tokens = 0
        prefill_s = decode_s = 0.0
        while queue or any(r is not None for r in self.slot_req):
            # refill free slots
            for s in range(self.B):
                if self.slot_req[s] is None and queue:
                    req = queue.pop(0)
                    tc = time.perf_counter()
                    logits = self.admit(req, s)
                    tok = int(torch.argmax(logits))
                    prefill_s += time.perf_counter() - tc
                    req.output.append(tok)
                    next_tok[s] = tok
                    if self._stopped(req, s, tok):
                        req.done = True
                        served_tokens += len(req.prompt) + len(req.output)
                        self.slot_req[s] = None
            if not any(r is not None for r in self.slot_req):
                # every admitted request stopped on its first token
                # (max_new=1 or an immediate EOS): back to admission (a
                # `break` here would drop the rest of the queue)
                continue
            # one lockstep decode step for all slots, its argmax read
            # back to the host
            tc = time.perf_counter()
            (logits,) = self._decode.run(next_tok, self.pos)
            active = np.array([r is not None for r in self.slot_req],
                              np.int32)
            self.pos = self.pos + active
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
            decode_s += time.perf_counter() - tc
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                req.output.append(int(toks[s]))
                next_tok[s] = toks[s]
                if self._stopped(req, s, int(toks[s])):
                    req.done = True
                    served_tokens += len(req.prompt) + len(req.output)
                    self.slot_req[s] = None
        dt = time.perf_counter() - t0
        return {
            "requests": float(len(requests)),
            "tokens": float(served_tokens),
            "seconds": dt,
            "tokens_per_s": served_tokens / dt if dt > 0 else 0.0,
            "prefill_seconds": prefill_s,
            "decode_seconds": decode_s,
        }
