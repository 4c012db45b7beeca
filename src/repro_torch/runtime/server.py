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
position.  When the mirrors make every slot greedy (the host knows it
from admission), a dispatch ends in the argmax instead: the sample
head's greedy rows are that argmax bit for bit, and its sorts and noise
over [slots, vocab] are skipped.

The KV cache is a paged block pool with per-slot block tables, a
refcounted allocator with admission backpressure, and a radix-tree
prefix cache whose shared blocks are copied on write
(`api.cow_copy_block`) — all host-side, as in the reference.

Every work unit reads the pool through the hand-written CUDA kernels
of kernels/paged_attention.py (``kernel=True``; for CPU tensors the
wrappers compute their plain versions).  The kernels agree with the
plain gather path to float32 rounding, not bitwise: they sum in
another order, so a bf16 value on a rounding boundary may round the
other way (tolerances in kernels/paged_attention.py).  Greedy tokens
can therefore differ from the gather path where two logits are within
that rounding of each other.

``fp8_kv=True`` stores the pool as e4m3 codes plus one float32 scale
per token row per kv head, (hd+4)/(2*hd) of the bf16 pool's bytes,
read by the fp8 kernels; ``fp8_linear=True`` quantizes every layer
weight to e4m3 once at init (te/linear.quantize_serving_params) and
serves each projection through te/linear.fp8_serving_dot.  Both change
numerics within fp8 rounding, as in the reference.

Not ported yet: the contiguous layout (``paged=False``), tensor
parallelism, open-loop serving and the slot baseline; passing any of
those options raises ``NotImplementedError``.
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
    """Chunked-prefill continuous-batching server (dense transformers).

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

    The host mirrors position/emission bookkeeping in numpy — greedy
    decoding with length-only stopping is deterministic, so the mirror
    never reads device state; with ``eos_id`` set the span's final
    pos/out_len/active state is read back instead.  `_ensure_blocks`
    assigns physical blocks as a slot's frontier advances, `_admit`
    reserves a request's worst case minus its prefix-cache hit and
    backpressures when the pool cannot hold it, and `_harvest` drops
    the slot's references.  The pool is updated in place.
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
        deferred = {"paged=False": not paged, "tp": tp != 1,
                    "mesh": mesh is not None}
        for name, on in deferred.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        if spec_decode < 0:
            raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.fp8_kv = bool(fp8_kv)
        # fp8_linear is tp=1 and dense only, as in the reference; the
        # port has neither tp nor other families yet, checked above
        self._quant = (te_linear.quantize_serving_params(params)
                       if fp8_linear else None)
        self.B = batch_slots
        self.max_len = max_len
        self.chunk = chunk
        self.span = span
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
        self.block_size = block_size
        # virtual blocks per slot; real writes never pass max_len
        self.max_blocks = -(-max_len // block_size)
        self.num_blocks = (batch_slots * self.max_blocks
                           if num_blocks is None else num_blocks)
        self.cache = api.init_cache(cfg, batch_slots, max_len,
                                    block_size=block_size,
                                    num_blocks=self.num_blocks,
                                    device=self.device, fp8_kv=self.fp8_kv)
        self.block_table = np.full((batch_slots, self.max_blocks), -1,
                                   np.int32)
        self.pool = BlockPool(self.num_blocks)
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if prefix_cache:
            self.prefix_cache = RadixPrefixCache(self.pool, block_size,
                                                 tracer=self.obs,
                                                 metrics=self.metrics)
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_slots)]
        self._num_shared = np.zeros(batch_slots, np.int32)
        self._cow_pending = [False] * batch_slots
        self._reserved = np.zeros(batch_slots, np.int32)
        self._reserved_total = 0
        self.peak_blocks = 0
        self.admission_stalls = 0
        self.total_prompt_tokens = 0
        self.cached_prompt_tokens = 0
        self.prefix_hits = 0
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
        if self.obs.enabled:
            self.obs.meta.update(
                batch_slots=self.B, chunk=self.chunk, span=self.span,
                max_len=self.max_len, num_layers=cfg.num_layers,
                kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                spec_decode=self.spec_decode, tp=1, paged=True,
                block_size=self.block_size, max_blocks=self.max_blocks,
                num_blocks=self.num_blocks,
                kv_read_mode="fp8_kernel" if self.fp8_kv else "kernel")

    def _put(self, x: np.ndarray) -> torch.Tensor:
        """Host->device copy of a scheduler operand (a few hundred
        int32s of intent, never activations or cache)."""
        return torch.as_tensor(x, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _samp_operands(self) -> Tuple[torch.Tensor, ...]:
        """The sampling mirrors as device operands."""
        return tuple(self._put(a.copy()) for a in (
            self.samp_temp, self.samp_top_k, self.samp_top_p,
            self.samp_seed))

    def _samp(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """The sample head's operands, or None when every slot is greedy
        (idle slots hold greedy values): the argmax head then stands in,
        equal to the sample head's greedy rows bit for bit."""
        if np.all((self.samp_temp <= 0.0) | (self.samp_top_k == 1)):
            return None
        return self._samp_operands()

    @staticmethod
    def _head(logits: torch.Tensor, samp, index: torch.Tensor
              ) -> torch.Tensor:
        """The next token of every slot: `sampling.sample_tokens`, or the
        argmax when `samp` is None."""
        if samp is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sampling.sample_tokens(logits, *samp, index)

    def launch_counts(self) -> Dict[str, int]:
        """Launches of the paged-attention kernels in this process (the
        wrappers' counts, bf16 and fp8 bodies; CPU runs launch none)."""
        return pk.launch_counts()

    # -- device work units ------------------------------------------------
    def _chunk_impl(self, tokens_host, pos, n_tokens, is_decode, emit,
                    out_len, samp, block_table) -> None:
        B, C = tokens_host.shape
        col0 = torch.arange(C, device=self.device) == 0
        tokens = torch.where(is_decode[:, None] & col0[None, :],
                             self.cur_tok[:, None], tokens_host)
        logits, self.cache = api.chunk_step(
            self.cfg, self.params, self.cache, tokens, pos, n_tokens,
            block_table, kernel=True, quant=self._quant)
        # the emitted token sits at position pos + n_tokens: the key of
        # the span and verify paths' draw for the same position
        nxt = self._head(logits, samp, pos + n_tokens)
        self.cur_tok = torch.where(emit, nxt, self.cur_tok)
        idx = out_len.long().clamp(0, self.max_len - 1)
        self.out_buf[self._rows, idx] = torch.where(
            emit, nxt, self.out_buf[self._rows, idx])

    def _span_impl(self, pos, out_len, active, max_new, samp, block_table
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cap = self.max_len - 1
        tok = self.cur_tok
        for _ in range(self.span):
            logits, self.cache = api.decode_step(
                self.cfg, self.params, self.cache, tok, pos, block_table,
                kernel=True, quant=self._quant)
            # emission position pos + 1 (before the increment)
            nxt = self._head(logits, samp, pos + 1)
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
        self.cur_tok = tok
        return pos, out_len, active

    def _spec_impl(self, pos, out_len, active, max_new, samp, block_table
                   ) -> Tuple[torch.Tensor, ...]:
        (self.cache, self.ngram_table, self.cur_tok, self.out_buf, pos,
         out_len, active, n_emit) = spec.spec_decode_step(
            self.cfg, self.params, self.cache, self.ngram_table,
            self.cur_tok, self.out_buf, pos, out_len, active, max_new,
            *(samp if samp is not None else (None,) * 4), block_table,
            max_len=self.max_len, eos_id=self.eos_id,
            fwd_kw={"kernel": True, "quant": self._quant})
        return pos, out_len, active, n_emit

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
            self.cache = api.cow_copy_block(self.cfg, self.cache, src, dst)
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
                shared: List[int] = []
                cow, cow_len = None, 0
                # cheap lower bound first: when even a fully-cached
                # prompt could not admit, skip the radix walk
                best_shared = (max((len(req.prompt) - 1)
                                   // self.block_size, 0)
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
                    break
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
                self._ensure_blocks(s, int(self.pos[s]) + n)
            elif self.mode[s] == "decode":
                n_tokens[s] = 1
                is_decode[s] = True
                emit[s] = True
                self._ensure_blocks(s, int(self.pos[s]) + 1)
        self._chunk_impl(self._put(tokens_host), self._put(self.pos.copy()),
                         self._put(n_tokens), self._put(is_decode),
                         self._put(emit), self._put(self.out_len.copy()),
                         self._samp(), self._put(self.block_table.copy()))
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
        for s in np.flatnonzero(active):
            self._ensure_blocks(s, int(sim_pos[s]))
        pos_d, out_d, act_d = self._span_impl(
            self._put(self.pos.copy()), self._put(self.out_len.copy()),
            self._put(active), self._put(max_new), self._samp(),
            self._put(self.block_table.copy()))
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
        slot's accepted frontier."""
        t0 = time.perf_counter()
        K = self.spec_decode
        active = np.array([m == "decode" for m in self.mode])
        if self.obs.enabled:
            kv_lens = tuple(int(p) for p in self.pos[active])
        max_new = np.array(
            [r.max_new if r is not None else 0 for r in self.slot_req],
            np.int32)
        cap = self.max_len - 1
        for s in np.flatnonzero(active):
            # cover the window only up to the slot's emit budget: rows
            # past it are never accepted and their writes drop past the
            # table, so the admission reservation always suffices
            budget = min(int(max_new[s]) - int(self.out_len[s]),
                         cap - int(self.pos[s]))
            self._ensure_blocks(
                s, int(self.pos[s]) + min(K + 1, max(budget, 1)))
        pos_d, out_d, act_d, emit_d = self._spec_impl(
            self._put(self.pos.copy()), self._put(self.out_len.copy()),
            self._put(active), self._put(max_new), self._samp(),
            self._put(self.block_table.copy()))
        emit = emit_d.cpu().numpy()
        self.pos = pos_d.cpu().numpy().astype(np.int32)
        self.out_len = out_d.cpu().numpy().astype(np.int32)
        done_now = active & ~act_d.cpu().numpy()
        t1 = time.perf_counter()
        # rejected drafts: shrink each frontier back to the accepted
        # positions (stale K/V past it is never read)
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
            0, self._put(np.asarray(done_slots, np.int64))).cpu().numpy()
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
        """Per-run metric and pool state (the tracer's event log
        accumulates across runs until the caller clears it)."""
        self.metrics.reset()
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
        queue = list(requests)
        self._reset_run_counters()
        if self.obs.enabled:
            for r in queue:
                self.obs.enqueue(r.rid, len(r.prompt), r.max_new)
        t0 = time.perf_counter()
        served_tokens = 0
        prefill_tokens = 0
        while queue or any(r is not None for r in self.slot_req):
            self._admit(queue)
            if any(m == "prefill" for m in self.mode):
                prefill_tokens += self._run_chunk_step()
            elif any(m == "decode" for m in self.mode):
                if self.spec_decode:
                    self._run_spec_step()
                else:
                    self._run_decode_span()
            served_tokens += self._harvest()
        dt = time.perf_counter() - t0
        return self._run_stats(requests, dt, served_tokens, prefill_tokens)

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
