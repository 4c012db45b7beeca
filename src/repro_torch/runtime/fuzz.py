"""Scheduler fuzz harness: the port's ChunkedServer host machinery under
random traffic, with model-free work units and an invariant audit after
every state transition.

PyTorch counterpart of ``repro/runtime/fuzz.py``.  The serving
scheduler's correctness surface (refcounted block accounting, radix-tree
residency, copy-on-write pins, speculative rollback, admission
backpressure and LRU eviction) is host-side; the work units only decide
WHICH tokens come out.  ``AuditedChunkedServer`` therefore replaces the
runs of the server's work units (``chunk_step``, ``decode_span``,
``verify_step``, ``cow_copy``) with seeded-random stand-ins that take
the units' operands and honour their contracts (emit rules, span stop
masks, verify acceptance bounds, EOS truncation), and drives the
scheduler's own code unchanged: every admit / block-assignment /
rollback / harvest / eviction path runs for real, at Python speed.  The
stand-ins draw from the ``np.random.Generator`` in the reference's order
and sizes, so one seed gives the reference's trace: the same outputs,
hits, evictions, copy-on-write resolves and rollbacks.

``_audit``, called after every host transition, asserts:

  * ``RadixPrefixCache.check_invariants`` (block-aligned edges,
    refcount/residency/free-list partition, per-block LRU stamps);
  * exact reservation accounting: per slot,
    ``owned + reserved == blocks_needed(req) + cow_pending`` (the
    admission promise is conserved by every draw/rollback), reserved
    totals match, and the free + evictable supply covers every
    outstanding reservation;
  * the pool refcounts equal the multiset of slot block-table
    references (the tree pins residency via ``cached``, never via
    refcount);
  * each block-table row mirrors its slot's owned-block list exactly.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.server import ChunkedServer, Request

__all__ = ["AuditedChunkedServer", "fuzz_config", "run_fuzz_trace"]


def fuzz_config(vocab: int = 32) -> ModelConfig:
    """Minimal dense config: the fakes never run the model, but the
    server still sizes its cache/pool tensors from it (kept tiny)."""
    return ModelConfig(name="fuzz", family="dense", num_layers=1,
                       d_model=8, num_heads=1, num_kv_heads=1,
                       head_dim=4, d_ff=16, vocab_size=vocab,
                       remat="none")


class AuditedChunkedServer(ChunkedServer):
    """ChunkedServer whose work units are seeded-random fakes and whose
    host transitions are followed by a full invariant audit.  `device`
    (a keyword of the server) holds the server's small tensors; the
    fakes read and write them through host copies."""

    def __init__(self, cfg: ModelConfig, *, rng: np.random.Generator,
                 **kw):
        kw.setdefault("paged", True)
        assert kw["paged"], "the fuzz harness audits the paged allocator"
        super().__init__(cfg, params=None, **kw)
        self._rng = rng
        self.audits = 0
        self._units["chunk_step"].run = self._fake_chunk
        self._units["decode_span"].run = self._fake_span
        if self.spec_decode:
            self._units["verify_step"].run = self._fake_verify
        self._units["cow_copy"].run = lambda src, dst: ()

    # -- model-free work-unit stand-ins -----------------------------------
    # Each fake honours its unit's contract exactly (see ChunkedServer.
    # _chunk_body/_span_body/_spec_body): random tokens are as good as
    # real logits for the host machinery, and a small vocab makes EOS /
    # repeated-prefix traffic frequent.

    def _tok(self, n: int = 1) -> np.ndarray:
        return self._rng.integers(0, self.cfg.vocab_size, n,
                                  dtype=np.int32)

    def _host_state(self):
        return (self.cur_tok.cpu().numpy().copy(),
                self.out_buf.cpu().numpy().copy())

    def _store(self, ct: np.ndarray, ob: np.ndarray) -> None:
        self.cur_tok.copy_(torch.from_numpy(ct))
        self.out_buf.copy_(torch.from_numpy(ob))

    def _tensors(self, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    def _fake_chunk(self, tokens_host, pos, n_tokens, is_decode, emit,
                    out_len, temp, top_k, top_p, seed, block_table):
        ct, ob = self._host_state()
        T = ob.shape[1]
        nxt = self._tok(self.B)
        for s in range(self.B):
            if emit[s]:
                ct[s] = nxt[s]
                ob[s, min(int(out_len[s]), T - 1)] = nxt[s]
        self._store(ct, ob)
        return ()

    def _fake_span(self, pos, out_len, active, max_new, temp, top_k, top_p,
                   seed, block_table):
        ct, ob = self._host_state()
        pos, out_len, act = pos.copy(), out_len.copy(), active.copy()
        T, cap = ob.shape[1], self.max_len - 1
        for _ in range(self.span):
            for s in np.flatnonzero(act):
                nxt = int(self._tok()[0])
                ob[s, min(int(out_len[s]), T - 1)] = nxt
                out_len[s] += 1
                pos[s] += 1
                ct[s] = nxt
                act[s] = (out_len[s] < max_new[s] and pos[s] < cap
                          and (self.eos_id is None or nxt != self.eos_id))
        self._store(ct, ob)
        return self._tensors(pos, out_len, act)

    def _fake_verify(self, pos, out_len, active, max_new, temp, top_k,
                     top_p, seed, block_table):
        K1 = self.spec_decode + 1
        ct, ob = self._host_state()
        pos, out_len, act = pos.copy(), out_len.copy(), active.copy()
        emit = np.zeros(self.B, np.int32)
        T, cap = ob.shape[1], self.max_len - 1
        for s in np.flatnonzero(act):
            # acceptance is data-dependent in [1, min(K+1, budget)]:
            # random here, which exercises every rollback depth
            budget = min(int(max_new[s]) - int(out_len[s]),
                         cap - int(pos[s]))
            w = int(self._rng.integers(1, min(K1, max(budget, 1)) + 1))
            toks = self._tok(w)
            eos_stop = False
            if self.eos_id is not None and self.eos_id in toks:
                w = int(np.flatnonzero(toks == self.eos_id)[0]) + 1
                toks = toks[:w]
                eos_stop = True
            for j in range(w):
                ob[s, min(int(out_len[s]) + j, T - 1)] = toks[j]
            out_len[s] += w
            pos[s] += w
            ct[s] = toks[-1]
            emit[s] = w
            act[s] = (out_len[s] < max_new[s] and pos[s] < cap
                      and not eos_stop)
        self._store(ct, ob)
        return self._tensors(pos, out_len, act, emit)

    # -- invariant audit ---------------------------------------------------

    def _audit(self) -> None:
        self.audits += 1
        if self.prefix_cache is not None:
            self.prefix_cache.check_invariants()
        assert (self._reserved >= 0).all(), "negative slot reservation"
        assert self._reserved_total == int(self._reserved.sum()), \
            "reservation total out of sync with per-slot reservations"
        evictable = (self.prefix_cache.evictable_blocks()
                     if self.prefix_cache is not None else 0)
        assert self._reserved_total <= self.pool.num_free() + evictable, \
            "outstanding reservations exceed the reclaimable supply"
        counts = np.zeros(self.num_blocks, np.int64)
        for s in range(self.B):
            owned = self._slot_blocks[s]
            row = self.block_table[s]
            assert [int(b) for b in row[:len(owned)]] == owned, \
                f"slot {s}: block table diverged from owned list"
            assert (row[len(owned):] == -1).all(), \
                f"slot {s}: stale block-table entries past the frontier"
            for b in owned:
                counts[b] += 1
            req = self.slot_req[s]
            if req is None:
                assert not owned and self._reserved[s] == 0
                continue
            # exact reservation accounting: the admission promise
            # (worst case + a mapped-but-unresolved COW block) is
            # conserved by every draw, COW resolve and rollback
            assert (len(owned) + int(self._reserved[s])
                    == self._blocks_needed(req)
                    + bool(self._cow_pending[s])), \
                f"slot {s}: owned+reserved drifted from blocks_needed"
        assert (self.pool.refcount == counts).all(), \
            "pool refcounts diverged from slot references"

    # -- audited host transitions -----------------------------------------

    def _admit(self, queue):
        super()._admit(queue)
        self._audit()

    def _ensure_blocks(self, s, upto):
        super()._ensure_blocks(s, upto)
        self._audit()

    def _truncate_blocks(self, s, upto):
        freed = super()._truncate_blocks(s, upto)
        self._audit()
        return freed

    def _harvest(self):
        served = super()._harvest()
        self._audit()
        return served


def _fuzz_requests(rng: np.random.Generator, n: int, vocab: int,
                   max_in: int, max_out: int,
                   templates: List[np.ndarray]) -> List[Request]:
    """Random mix biased toward shared prefixes cut at NON-block-
    aligned points (partial radix matches -> copy-on-write) plus
    genuinely fresh prompts and exact repeats."""
    reqs = []
    for i in range(n):
        kind = rng.random()
        if kind < 0.5 and templates:
            t = templates[int(rng.integers(len(templates)))]
            cut = int(rng.integers(1, len(t) + 1))
            tail = rng.integers(0, vocab,
                                int(rng.integers(0, 4)), dtype=np.int32)
            prompt = np.concatenate([t[:cut], tail])[:max_in]
        else:
            prompt = rng.integers(0, vocab,
                                  int(rng.integers(1, max_in + 1)),
                                  dtype=np.int32)
        reqs.append(Request(rid=i, prompt=prompt.astype(np.int32),
                            max_new=int(rng.integers(1, max_out + 1))))
    return reqs


def run_fuzz_trace(seed: int, *, waves: int = 2, requests_per_wave: int = 6,
                   device=None) -> AuditedChunkedServer:
    """One randomized serving trace: random knobs (block size, pool
    pressure, spec window, EOS), random shared-prefix traffic, `waves`
    serve() calls against a warm tree, an audit after every host
    transition, and a final quiescence check.  Returns the server so
    callers can assert on coverage counters.  `device` holds the
    server's tensors (the CUDA device unless the caller passes
    another)."""
    rng = np.random.default_rng(seed)
    vocab = int(rng.integers(6, 48))
    cfg = fuzz_config(vocab)
    block_size = int(rng.choice([2, 3, 4, 8]))
    slots = int(rng.integers(2, 5))
    max_out = int(rng.integers(1, 10))
    max_in = int(rng.integers(2, 17))
    max_len = max_in + max_out + int(rng.integers(0, 5))
    templates = [rng.integers(0, vocab, int(rng.integers(2, max_in + 1)),
                              dtype=np.int32)
                 for _ in range(int(rng.integers(1, 4)))]
    wave_reqs = [_fuzz_requests(rng, requests_per_wave, vocab, max_in,
                                max_out, templates)
                 for _ in range(waves)]
    worst = max(-(-min(len(r.prompt) + r.max_new, max_len) // block_size)
                for w in wave_reqs for r in w)
    # a pool barely above the single-request worst case keeps the
    # allocator under constant backpressure/eviction pressure
    num_blocks = worst + int(rng.integers(0, 4))
    srv = AuditedChunkedServer(
        cfg, rng=rng, batch_slots=slots, max_len=max_len,
        chunk=int(rng.choice([2, 4, 8])), span=int(rng.choice([1, 2, 4])),
        block_size=block_size, num_blocks=num_blocks, prefix_cache=True,
        eos_id=(1 if rng.random() < 0.5 else None),
        spec_decode=int(rng.choice([0, 2, 3])), spec_n_ctx=64,
        device=device)
    for reqs in wave_reqs:
        srv.serve(reqs)
        assert all(r.done for r in reqs)
        # quiescence between waves: every reference dropped, every
        # reservation restored, nothing leaked: blocks are either free
        # or tree-resident (evictable)
        assert int(srv.pool.refcount.sum()) == 0
        assert srv._reserved_total == 0
        assert (srv.block_table == -1).all()
        assert (srv.pool.num_free()
                + srv.prefix_cache.cached_block_count()
                == srv.num_blocks)
    assert srv.audits > 0
    return srv
