"""Speculative decoding: device-resident n-gram drafting + batched
verify over the paged KV pool.

PyTorch counterpart of ``repro/runtime/spec_decode.py``.  A decode step
emits one token per slot and reads every weight once for it;
speculative decoding widens the work of one dispatch without changing
the emitted tokens: an n-gram table drafts K continuation tokens per
slot, ONE `verify_step` call (the chunk forward, through the paged
chunk kernel at C = K + 1 rows) scores all B x (K+1) tokens, and the
server accepts the longest draft prefix that matches the model's own
next-token chain.  Greedy slots emit the argmax chain, so K>0 emits
the tokens of K=0; sampled slots draw every verify row with the sample
head keyed by (seed, emission position), which is speculative sampling
for a point-mass drafter (accept draft d with probability p(d), else
the first mismatching draw is the residual resample), so K>0 emits the
K=0 sampled tokens given the seed.

Drafting is one ``[n_ctx, K]`` int32 table shared by every slot,
mapping a hash of the last two emitted tokens to the K tokens that most
recently followed that context anywhere in the batch.  The lookup
(`propose`) and the update (`update_ngram`, from the tokens just
emitted, read out of the device-side output buffer) are tensor ops on
the device.  Where one update holds the same context twice, the last
row in flattened (slot, window row) order wins, deterministically (the
reference leaves the choice to its scatter); either is a genuinely
observed continuation, so this can change acceptance counts, never
tokens.

Cache semantics: `verify_step` writes K/V for all K+1 window rows at
[pos, pos+K].  After acceptance the valid frontier is ``pos + n_emit``;
the rejected rows' writes sit beyond it, where no read looks before the
next window's writes land, or past the slot's allocated blocks, where
the write was dropped.  The server rolls the slot's block table back to
the frontier (`ChunkedServer._truncate_blocks`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import api

# Context-hash multiplier: a prime that spreads (prev, cur) token pairs
# over the table without degenerating modulo the power-of-two n_ctx.
_HASH_PRIME = 7919
DEFAULT_N_CTX = 32768


def ngram_hash(t_prev: torch.Tensor, t_cur: torch.Tensor,
               n_ctx: int) -> torch.Tensor:
    """Bucket of the 2-token context (t_prev, t_cur), int32 arithmetic
    as in the reference (the product wraps for vocabularies past
    ~270k; the remainder takes the sign of n_ctx, as jnp's does)."""
    h = (t_prev.to(torch.int32) * _HASH_PRIME + t_cur.to(torch.int32))
    return torch.remainder(h, n_ctx)


def init_ngram_table(k: int, n_ctx: int = DEFAULT_N_CTX,
                     device=None) -> torch.Tensor:
    """Suffix-lookup table [n_ctx, K] int32, shared by every slot;
    zero-init (an unseen context drafts token 0, verified like any
    other draft)."""
    return torch.zeros((n_ctx, k), dtype=torch.int32, device=device)


def propose(table: torch.Tensor, cur_tok: torch.Tensor,
            out_buf: torch.Tensor, out_len: torch.Tensor) -> torch.Tensor:
    """Draft K tokens per slot from the suffix table: the context is
    the slot's pending token and its predecessor in the output buffer
    (0 while out_len < 2).  [B, K] int32."""
    n_ctx = table.shape[0]
    B, T = out_buf.shape
    row = torch.arange(B, device=out_buf.device)
    i2 = (out_len.long() - 2).clamp(0, T - 1)
    t_prev = torch.where(out_len >= 2, out_buf[row, i2],
                         torch.zeros_like(cur_tok))
    return table[ngram_hash(t_prev, cur_tok, n_ctx).long()]


def accept_greedy(drafts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Longest-prefix acceptance: n_acc[b] = the number of leading
    drafts equal to the model's chain (drafts [B, K] vs preds [B, K+1]:
    draft j is checked against preds[:, j]).  [B] int32."""
    K = drafts.shape[1]
    match = (drafts == preds[:, :K]).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)


def update_ngram(table: torch.Tensor, out_buf: torch.Tensor,
                 out_len: torch.Tensor, active: torch.Tensor
                 ) -> torch.Tensor:
    """Learn from the tokens just emitted.

    For each run of K output tokens whose last token just landed
    (starts p = out_len - K - j, j in [0, K]), store ``out_buf[p:p+K]``
    under the hash of its context ``(out_buf[p-2], out_buf[p-1])``.
    Runs reaching into the prompt (p < 2) and inactive slots are
    dropped; of rows with the same context the last in flattened
    (slot, j) order wins.  Returns the updated table (a new tensor)."""
    n_ctx, K = table.shape
    B, T = out_buf.shape
    dev = out_buf.device
    j = torch.arange(K + 1, dtype=torch.int32, device=dev)
    p = out_len.to(torch.int32)[:, None] - K - j[None, :]      # [B, K+1]
    ok = (active[:, None] & (p >= 2)).reshape(-1)
    c_prev = out_buf.gather(1, (p - 2).long().clamp(0, T - 1))
    c_cur = out_buf.gather(1, (p - 1).long().clamp(0, T - 1))
    ctx = ngram_hash(c_prev, c_cur, n_ctx).reshape(-1)          # [N]
    run_idx = (p[:, :, None].long()
               + torch.arange(K, device=dev)[None, None, :]).clamp(0, T - 1)
    runs = out_buf.gather(1, run_idx.reshape(B, (K + 1) * K))
    runs = runs.reshape(B * (K + 1), K)
    # a row wins unless a later kept row has the same context
    N = ctx.shape[0]
    later = torch.triu(torch.ones((N, N), dtype=torch.bool, device=dev), 1)
    beaten = ((ctx[:, None] == ctx[None, :]) & ok[None, :] & later).any(1)
    idx = torch.where(ok & ~beaten, ctx, n_ctx).long()
    # dropped rows land on one spare row past the table
    out = torch.cat([table, table.new_zeros((1, K))])
    out.index_put_((idx,), runs)
    return out[:n_ctx]


def spec_decode_step(cfg, params, cache, table: torch.Tensor,
                     cur_tok: torch.Tensor, out_buf: torch.Tensor,
                     pos: torch.Tensor, out_len: torch.Tensor,
                     active: torch.Tensor, max_new: torch.Tensor,
                     samp_temp: Optional[torch.Tensor],
                     samp_top_k: Optional[torch.Tensor],
                     samp_top_p: Optional[torch.Tensor],
                     samp_seed: Optional[torch.Tensor],
                     block_table: torch.Tensor, *, max_len: int,
                     eos_id: Optional[int], fwd_kw: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """One draft -> verify -> accept step for every decoding slot.

    Per active slot it emits ``n_emit = accepted drafts + 1`` tokens
    (>= 1), capped by the slot's budget ``min(max_new - out_len,
    max_len - 1 - pos)`` and cut after the first emitted ``eos_id``
    (the EOS itself is emitted, then the slot stops).  The emitted
    tokens are the model's own chain ``preds[:, :n_emit]`` (argmax for
    greedy slots, the position-keyed draws for sampled ones); drafts
    only decide how many rows of it are usable.  ``samp_temp=None``
    (every slot greedy) runs the argmax head, the sample head's greedy
    rows bit for bit.

    Returns (cache, table, cur_tok, out_buf, pos, out_len, active,
    n_emit), n_emit 0 for inactive slots; `out_buf` is updated in place
    and returned."""
    B, K1 = cur_tok.shape[0], table.shape[1] + 1
    K = K1 - 1
    T = out_buf.shape[1]
    dev = cur_tok.device
    iota = torch.arange(K1, dtype=torch.int32, device=dev)
    cap = max_len - 1

    drafts = propose(table, cur_tok, out_buf, out_len)        # [B, K]
    window = torch.cat([cur_tok[:, None], drafts], dim=1)
    sample = (None if samp_temp is None
              else (samp_temp, samp_top_k, samp_top_p, samp_seed))
    preds, cache = api.verify_step(cfg, params, cache, window, pos,
                                   block_table, sample=sample,
                                   **(fwd_kw or {}))          # [B, K+1]

    n_acc = accept_greedy(drafts, preds)
    budget = torch.clamp_min(
        torch.minimum(max_new - out_len, cap - pos), 0)
    n_emit = torch.minimum(n_acc + 1, budget)
    eos_stop = torch.zeros(B, dtype=torch.bool, device=dev)
    if eos_id is not None:
        eos_j = torch.where(preds == eos_id, iota[None, :],
                            torch.full_like(preds, K1)).amin(dim=1)
        n_emit = torch.minimum(n_emit, eos_j + 1)
        eos_stop = eos_j < n_emit
    n_emit = torch.where(active, n_emit, torch.zeros_like(n_emit))

    # scatter the emitted window preds[:, :n_emit] into the output
    # buffer; masked rows land on a spare column past it
    ok = active[:, None] & (iota[None, :] < n_emit[:, None])
    col = torch.where(ok, out_len[:, None] + iota[None, :],
                      torch.full_like(preds, T)).long()
    ext = torch.cat([out_buf, out_buf.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, col, preds)
    out_buf.copy_(ext[:, :T])

    out_len = out_len + n_emit
    pos = pos + n_emit
    last = preds.gather(1, (n_emit.long() - 1).clamp(0, K)[:, None])[:, 0]
    cur_tok = torch.where(n_emit > 0, last, cur_tok)
    active = active & (out_len < max_new) & (pos < cap) & ~eos_stop
    table = update_ngram(table, out_buf, out_len, n_emit > 0)
    return cache, table, cur_tok, out_buf, pos, out_len, active, n_emit


def record_dispatch(metrics, tracer, *, t0: float, t1: float, k: int,
                    n_active: int, emitted: int, accepted: int,
                    kv_lens: Tuple[int, ...] = ()) -> None:
    """Host-side acceptance accounting for one verify step, from python
    scalars already on the host: ``serving.dispatches.verify`` /
    ``serving.wall_s.verify``, the drafted / accepted / emitted
    counters, the per-dispatch histograms ``serving.spec.
    tokens_per_slot`` (emitted tokens per active slot) and
    ``serving.spec.accept_rate`` (accepted / drafted), and a
    ``verify_dispatch`` trace span with the pre-dispatch context
    lengths."""
    metrics.counter("serving.dispatches.verify").inc()
    metrics.histogram("serving.wall_s.verify").record(t1 - t0)
    metrics.counter("serving.spec.drafted").inc(k * n_active)
    metrics.counter("serving.spec.accepted").inc(accepted)
    metrics.counter("serving.spec.emitted").inc(emitted)
    if n_active:
        metrics.histogram("serving.spec.tokens_per_slot").record(
            emitted / n_active)
    if k * n_active:
        metrics.histogram("serving.spec.accept_rate").record(
            accepted / (k * n_active))
    if tracer.enabled:
        tracer.span("verify_dispatch", t0, t1, steps=1,
                    n_active=n_active, emitted=emitted,
                    accepted=accepted, kv_lens=kv_lens)
