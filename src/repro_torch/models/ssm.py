"""State-space mixers: Mamba-1 selective scan and Mamba-2 SSD.

PyTorch counterpart of ``repro/models/ssm.py``.  Both mixers are
written chunk-wise: a loop over sequence chunks carries the recurrent
state, and only one chunk's [B, C, d, N] (Mamba-1) or [B, H, C, C]
(SSD) intermediates are live at a time.  The recurrence runs in
float32; the projections run in the activations' dtype.

Mamba-1's in-chunk recurrence h_t = dA_t h_{t-1} + dBx_t is the
reference's ``lax.associative_scan`` of (a1 a2, a2 b1 + b2), rebuilt
pair for pair (``associative_scan``): the same float32 products in the
same tree, O(log C) ops a chunk.  Everything here is torch ops: the
reference's scans are XLA ops and reach no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, rmsnorm, xshard_sum
from repro_torch.sharding.axes import MODEL_AXIS


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold (torch's
    ``F.softplus`` returns x itself past 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ----------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ----------------------------------------------------------------------

def mamba1_specs(cfg) -> Dict[str, ParamSpec]:
    d, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.dt_rank, cfg.conv_width)
    return {
        "w_in": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((W, di), (None, "ssm_inner"),
                            scale=W ** -0.5),
        "conv_b": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "w_x": ParamSpec((di, R + 2 * N), ("ssm_inner", None)),
        "w_dt": ParamSpec((R, di), (None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((di, N), ("ssm_inner", None), init="ones"),
        "d_skip": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,L,C]; w: [W,C]. Returns (y, new_state).

    `state` is the trailing W-1 inputs of the previous segment
    ([B,W-1,C]); zeros at the start of a sequence.  The W taps are
    added in float32 in order, then the bias; y is cast to x.dtype.
    """
    B, L, C = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)       # [B, L+W-1, C]
    y = torch.zeros((B, L, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + L].float() * w[i].float()
    y = y + b.float()
    return y.to(x.dtype), xp[:, L:]


def _combine(e1, e2):
    """The scan's operator on (a, b) pairs: (a1 a2, a2 b1 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (even has as
    many rows as odd or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) along dim 1 under `_combine`, in
    ``lax.associative_scan``'s tree: adjacent pairs combined, the
    half-length scan by recursion (the odd outputs), then each odd
    output combined with the next even input (the even outputs)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _scan_chunk(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk scan of h_t = dA_t h_{t-1} + dBx_t.

    dA, dBx: [B, C, d, N]; h0: [B, d, N].  Returns (h over chunk, h_last).
    """
    a, b = associative_scan(dA, dBx)
    h = a * h0[:, None] + b
    return h, h[:, -1]


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along dim 1 of [B, L, ...]."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t


def _mamba1_scan(xs, delta, Bm, Cm, A, h, chunk: int):
    """The selective scan over chunks of `chunk` rows (the last
    zero-padded past L) from the state h [B, di, N]: (y [B, L, di]
    float32, the last state).  Each channel's recurrence is its own."""
    L = xs.shape[1]
    C_ = min(chunk, L)
    pad = (-L) % C_
    xs_p, delta, Bm, Cm = (_pad_rows(t, pad) for t in (xs, delta, Bm, Cm))
    ys = []
    for c in range((L + pad) // C_):
        rows = slice(c * C_, (c + 1) * C_)
        dc = delta[:, rows]
        dA = torch.exp(dc[..., None] * A)                     # [B,C,di,N]
        dBx = (dc * xs_p[:, rows].float())[..., None] \
            * Bm[:, rows].float()[:, :, None, :]              # [B,C,di,N]
        hs, h = _scan_chunk(dA, dBx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, rows].float()))
    return torch.cat(ys, dim=1)[:, :L], h


def mamba1_mixer(cfg, p, x: torch.Tensor, *, chunk: int = 128,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,L,d] -> ([B,L,d], new_state{ssm,conv}). fp32 recurrence.

    Chunks of `chunk` rows (the last zero-padded past L: a zero delta
    gives dA = 1 and dBx = 0, so the state passes the padding
    unchanged); the returned state is new tensors."""
    B, L, d = x.shape
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dt = x.dtype

    xz = x @ p["w_in"].to(dt)
    xs, z = xz.split(di, dim=-1)

    conv_state = None if state is None else state["conv"]
    xs, conv_state = causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    proj = xs @ p["w_x"].to(dt)
    dt_lr, Bm, Cm = proj.split([R, N, N], dim=-1)
    delta = softplus((dt_lr @ p["w_dt"].to(dt)).float()
                     + p["dt_bias"].float())                  # [B,L,di]
    A = -torch.exp(p["a_log"].float())                        # [di,N]

    h = (torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"])
    y, h = _mamba1_scan(xs, delta, Bm, Cm, A, h, chunk)
    y = y + xs.float() * p["d_skip"].float()
    y = y.to(dt) * F.silu(z)
    out = y @ p["w_out"].to(dt)
    return out, {"ssm": h, "conv": conv_state}


def mamba1_state(cfg, batch: int, dtype=torch.bfloat16, device=None
                 ) -> Dict[str, torch.Tensor]:
    return {
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


# ----------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ----------------------------------------------------------------------

def mamba2_specs(cfg) -> Dict[str, ParamSpec]:
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_width
    H = di // cfg.ssm_head_dim
    conv_dim = di + 2 * N          # x, B, C all pass the conv
    return {
        "w_in": ParamSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((W, conv_dim), (None, "ssm_inner"),
                            scale=W ** -0.5),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "norm_scale": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> [..., T, T] with out[...,i,j] = sum_{j<k<=i} x_k
    (differences of the cumulative sum); -inf above the diagonal, set
    before the caller's exp."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def _ssd_scan(xs, Bm, Cm, dA, delta, h, chunk: int):
    """SSD over chunks of `chunk` rows (the last zero-padded past L)
    from the state h [B, H, P, N]: the intra-chunk quadratic term, the
    inter-chunk term from the carried state and the state update.
    Returns (y [B, L, H, P] float32, the last state).  Each head is its
    own."""
    B, L = xs.shape[:2]
    H, P = h.shape[1], h.shape[2]
    Q = min(chunk, L)
    pad = (-L) % Q
    xs_p, Bm, Cm, dA, delta = (_pad_rows(t, pad)
                               for t in (xs, Bm, Cm, dA, delta))
    ys = []
    for c in range((L + pad) // Q):
        rows = slice(c * Q, (c + 1) * Q)
        bcf = Bm[:, rows].float()                             # [B,Q,N]
        ccf = Cm[:, rows].float()
        ac = dA[:, rows].transpose(1, 2)                      # [B,H,Q]
        # delta-weighted x, [B,Q,H,P]
        xcf = xs_p[:, rows].reshape(B, Q, H, P).float() \
            * delta[:, rows][..., None]
        a_cum = torch.cumsum(ac, dim=-1)                      # [B,H,Q]
        # intra-chunk (the "attention-like" quadratic term)
        Lmat = torch.exp(_segsum(ac))                         # [B,H,Q,Q]
        scores = torch.einsum("bln,bsn->bls", ccf, bcf)[:, None] * Lmat
        y_diag = torch.einsum("bhls,bshp->blhp", scores, xcf)
        # inter-chunk via carried state
        y_off = torch.einsum("bln,bhpn->blhp", ccf, h) \
            * torch.exp(a_cum).transpose(1, 2)[..., None]
        # state update for the next chunk
        decay = torch.exp(a_cum[..., -1:] - a_cum)            # [B,H,Q]
        h = h * torch.exp(a_cum[..., -1])[..., None, None] \
            + torch.einsum("bsn,bshp->bhpn", bcf,
                           xcf * decay.transpose(1, 2)[..., None])
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1)[:, :L], h                     # [B,L,H,P]


def mamba2_mixer(cfg, p, x: torch.Tensor, *, chunk: int = 64,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSD forward. x: [B,L,d]. State: {ssm:[B,H,P,N], conv:[B,W-1,conv]}.

    Per chunk of `chunk` rows: the intra-chunk quadratic term, the
    inter-chunk term from the carried state and the state update; then
    the d_skip term and the gated RMSNorm (epsilon 1e-6, as
    common.rmsnorm) before the output projection."""
    B, L, d = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = di // P
    dt = x.dtype

    proj = x @ p["w_in"].to(dt)
    z, xBC, dt_raw = proj.split([di, di + 2 * N, H], dim=-1)
    conv_state = None if state is None else state["conv"]
    xBC, conv_state = causal_conv1d(xBC, p["conv_w"], p["conv_b"],
                                    conv_state)
    xBC = F.silu(xBC)
    xs, Bm, Cm = xBC.split([di, N, N], dim=-1)

    delta = softplus(dt_raw.float() + p["dt_bias"].float())   # [B,L,H]
    A = -torch.exp(p["a_log"].float())                        # [H]
    dA = delta * A                                            # [B,L,H]

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"])
    y, h = _ssd_scan(xs, Bm, Cm, dA, delta, h, chunk)
    y = y + xs.reshape(B, L, H, P).float() * p["d_skip"].float()[:, None]
    y = y.reshape(B, L, di).to(dt)

    # gated RMSNorm (mamba2's norm-before-out)
    y = rmsnorm(y * F.silu(z), p["norm_scale"], eps=1e-6)
    out = y @ p["w_out"].to(dt)
    return out, {"ssm": h, "conv": conv_state}


def mamba2_state(cfg, batch: int, dtype=torch.bfloat16, device=None
                 ) -> Dict[str, torch.Tensor]:
    H = cfg.d_inner // cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


# ----------------------------------------------------------------------
# the sharded training step: Mamba-1 channels / Mamba-2 heads over `model`
# ----------------------------------------------------------------------

def _rows_partial(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float32 partial [1, B, L, n] of y @ w over a position's rows
    of the contraction (y's dtype operands, read in float32)."""
    return (y.float() @ w.to(y.dtype).float())[None]


def _once(cfg, mixer, p, g, h, read, chunk: int):
    """The whole mixer on the group's first worker (a split `model` does
    not divide), copied to the group's other devices."""
    w = g.workers[0]
    y, _ = mixer(cfg, read.whole(p, w), h[w.device], chunk=chunk)
    return {d: y.to(d) for d in g.devices}


def sharded_mamba1(cfg, p, g, h, read, *, chunk: int = 128):
    """`mamba1_mixer` of one data group of the sharded training step
    (models/transformer.py's groups and reader; `p` the layer's
    ``Sharded`` leaves, h the normed input on each group device), the
    `d_inner` channels split over `model`: position m takes channels
    c_m = [m di/M, (m+1) di/M), the x columns c_m and the z columns
    di + c_m of w_in (read across its blocks: `model` splits w_in's
    2 di columns contiguously, so x and z lie in different blocks), and
    its conv, dt, A and skip channels.  x_proj contracts over the split
    channels: each position's float32 partial is summed in model order
    (``xshard_ssm_xproj``), giving dt_lr, B and C on every device; the
    scan runs over the position's channels alone (the recurrence is
    diagonal); the out-projection partials are summed
    (``xshard_ssm_out``).  Where `model` does not split d_inner the
    mixer runs once.  Returns the output [B, L, d] on each device."""
    if p["conv_b"].split(MODEL_AXIS) is None:
        return _once(cfg, mamba1_mixer, p, g, h, read, chunk)
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    n = di // p["conv_b"].parts(MODEL_AXIS)
    mine = []
    for w in g.workers:
        x = h[w.device]
        dt = x.dtype
        lo, hi = w.m * n, (w.m + 1) * n

        def span(name, dim, a=lo, b=hi, w=w):
            return read.span(p[name], w, dim, a, b)

        xs = x @ span("w_in", 1).to(dt)
        z = x @ span("w_in", 1, di + lo, di + hi).to(dt)
        xs, _ = causal_conv1d(xs, span("conv_w", 1), span("conv_b", 0))
        mine.append((w, span, F.silu(xs), z))
    proj = xshard_sum([_rows_partial(xs, span("w_x", 0))
                       for _, span, xs, _ in mine], g.devices,
                      tag="xshard_ssm_xproj")
    # rounded to x's dtype once a device, then shared in float32, so the
    # positions' gradients of dt_lr, B and C add in float32 and round
    # once, as the one-device mixer's sum over all channels does
    proj = {d: v.to(h[d].dtype).float() for d, v in proj.items()}
    parts = []
    for w, span, xs, z in mine:
        B, L = xs.shape[:2]
        dt = xs.dtype
        dt_lr, Bm, Cm = proj[w.device].split([R, N, N], dim=-1)
        delta = softplus((dt_lr.to(dt) @ span("w_dt", 1).to(dt)).float()
                         + span("dt_bias", 0).float())
        A = -torch.exp(span("a_log", 0).float())
        h0 = torch.zeros((B, n, N), dtype=torch.float32, device=xs.device)
        y, _ = _mamba1_scan(xs, delta, Bm, Cm, A, h0, chunk)
        y = y + xs.float() * span("d_skip", 0).float()
        parts.append(_rows_partial(y.to(dt) * F.silu(z), span("w_out", 0)))
    ys = xshard_sum(parts, g.devices, tag="xshard_ssm_out")
    return {d: ys[d].to(h[d].dtype) for d in g.devices}


def sharded_mamba2(cfg, p, g, h, read, *, chunk: int = 64):
    """`mamba2_mixer` of one data group of the sharded training step,
    its heads split over `model`: position m takes heads h_m (H/M of
    them, channels c_m), reads the w_in columns and conv channels of its
    z, x and dt heads, and all of B and C (ngroups 1: projected and
    convolved once, on the group's first worker), and runs the SSD
    chunks on its heads.  The gated
    RMSNorm's mean of squares over the whole d_inner is each position's
    float32 row sum of squares, summed in model order
    (``xshard_ssm_norm``) and divided by d_inner; the out-projection
    partials are summed (``xshard_ssm_out``).  Where `model` does not
    split the heads the mixer runs once.  Returns the output [B, L, d]
    on each device."""
    if p["a_log"].split(MODEL_AXIS) is None:
        return _once(cfg, mamba2_mixer, p, g, h, read, chunk)
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    Hm = di // P // p["a_log"].parts(MODEL_AXIS)
    n = Hm * P
    # B and C (every head reads them) once, on the group's first worker,
    # shared in float32: the positions' gradients add in float32 and
    # round once, as the one-device mixer's sum over all heads does
    w0 = g.workers[0]
    bc = h[w0.device] @ read.span(p["w_in"], w0, 1, 2 * di,
                                  2 * di + 2 * N).to(h[w0.device].dtype)
    bc, _ = causal_conv1d(bc, read.span(p["conv_w"], w0, 1, di, di + 2 * N),
                          read.span(p["conv_b"], w0, 0, di, di + 2 * N))
    bc = F.silu(bc).float()
    bcs = {d: bc.to(d) for d in g.devices}
    mine = []
    for w in g.workers:
        x = h[w.device]
        B, L = x.shape[:2]
        dt = x.dtype
        lo, hi = w.m * n, (w.m + 1) * n
        hlo, hhi = w.m * Hm, (w.m + 1) * Hm

        def span(name, dim, a=lo, b=hi, w=w):
            return read.span(p[name], w, dim, a, b)

        z = x @ span("w_in", 1).to(dt)
        xs = x @ span("w_in", 1, di + lo, di + hi).to(dt)
        dt_raw = x @ span("w_in", 1, 2 * di + 2 * N + hlo,
                          2 * di + 2 * N + hhi).to(dt)
        xs, _ = causal_conv1d(xs, span("conv_w", 1), span("conv_b", 0))
        xs = F.silu(xs)
        Bm, Cm = bcs[w.device].split([N, N], dim=-1)
        delta = softplus(dt_raw.float() + span("dt_bias", 0, hlo, hhi)
                         .float())
        dA = delta * -torch.exp(span("a_log", 0, hlo, hhi).float())
        h0 = torch.zeros((B, Hm, P, N), dtype=torch.float32, device=x.device)
        y, _ = _ssd_scan(xs, Bm, Cm, dA, delta, h0, chunk)
        y = y + xs.reshape(B, L, Hm, P).float() \
            * span("d_skip", 0, hlo, hhi).float()[:, None]
        gz = y.reshape(B, L, n).to(dt) * F.silu(z)
        mine.append((w, span, gz))
    ss = xshard_sum([gz.float().square().sum(-1, keepdim=True)[None]
                     for _, _, gz in mine], g.devices, tag="xshard_ssm_norm")
    parts = []
    for w, span, gz in mine:
        r = torch.rsqrt(ss[w.device] / di + 1e-6)
        y = (gz.float() * r * span("norm_scale", 0).float()).to(gz.dtype)
        parts.append(_rows_partial(y, span("w_out", 0)))
    ys = xshard_sum(parts, g.devices, tag="xshard_ssm_out")
    return {d: ys[d].to(h[d].dtype) for d in g.devices}


def ssm_flops_per_token(cfg, mamba2: bool = False) -> float:
    """Projection + scan FLOPs per token (fwd)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    proj = 2.0 * d * (2 * di) + 2.0 * di * d     # in/out projections
    if mamba2:
        H = di // cfg.ssm_head_dim
        proj = 2.0 * d * (2 * di + 2 * N + H) + 2.0 * di * d
        scan = 2.0 * di * N * 4                  # state update + readout
    else:
        proj += 2.0 * di * (cfg.dt_rank + 2 * N) + 2.0 * cfg.dt_rank * di
        scan = 2.0 * di * N * 4
    return proj + scan
