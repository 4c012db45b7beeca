"""Port vs reference: the encdec family (whisper-small, models/encdec.py)
and the API's shape cells.

The reduced whisper-small (2 + 2 layers, d 64, H = KH = 4, hd 16,
max_source_len 32, max_target_len 16) with the reference's weights
(`repro.models.api.init`, float32), every bias and every layernorm scale
and bias perturbed by seeded noise (the reference initialises them to
zeros and ones, where a wrong term would not show), bridged with
`convert.from_reference`.  The reference's outputs are computed once per
module (`ref`, its functions jitted), then the port's are held to them.

Tolerances, from readings on these inputs (bf16 steps: 2**-7 of the
reference's max |x|):

* float32 activations (the reference's ``jnp.bfloat16`` read as float32
  in models/encdec.py and the port's embedding rows kept float32,
  `_f32_acts`): the same arithmetic up to XLA's reduction orders.
  Encoder, decoder and served logits within F32_STEPS (read: <= 1.1e-2
  steps), the loss within 1e-5 relative (read: 1e-7), every gradient
  leaf within F32_GRAD of its max |g| (read: <= 1.7e-4).  The key
  biases' exact gradient is 0 (softmax is invariant to a shift of one
  query's scores), so bk's gradient is rounding noise on both sides:
  it is held within F32_GRAD of the max |g| of its block's bq.
* bf16 activations (the shipped path): the reduced model is chaotic in
  bf16 (its bf16 decoder lies 56-86 bf16 steps from its float32 run).
  Outputs are held against the reference's own bf16 noise, `noise`: the
  reference's bf16 output's distance from its float32 output, in bf16
  steps.  The port lies within max(MODEL_STEPS, NOISE x noise) of the
  reference's float32 output (read: port and reference lie at the same
  distance, ratio <= 1.05).  The loss within 5e-3 of the reference's
  same-dtype loss (read: 1.9e-3).  Gradients: each leaf within NOISE
  times the reference's own bf16 gradient's distance from its float32
  gradient, plus 5% of max |g|.
* float32 frames (the mixed case): the encoder runs in float32 (held at
  F32_STEPS), the decoder in bf16 with cross-attention k/v promoted to
  float32 as JAX promotes them; `_cross_block` on those operands within
  one bf16 step of the reference's.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.tree import items_with_path, tree_map
from repro_torch.models import api, convert, encdec
from repro_torch.runtime.trainer import value_and_grad

ARCH = "whisper-small"
F32_STEPS = 0.05
F32_GRAD = 1e-3
MODEL_STEPS = 8
NOISE = 3.0
B, T = 2, 16                 # batch, decoder tokens (max_target_len)
S_ENC = (24, 32)             # < max_source_len and = max_source_len
DECODE_STEPS = 12


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return convert.to_torch(np.asarray(x), "cpu")


def _steps(a, b) -> float:
    """|a - b| max over (2**-7 * max |a|): bf16 steps of a's scale."""
    a = _np(a)
    b = b.float().numpy() if torch.is_tensor(b) else _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / (2.0 ** -7 * np.abs(a).max()))


class _F32Numpy:
    """jax.numpy with `bfloat16` read as float32 (the reference's
    decoder casts the embedding to ``jnp.bfloat16`` inline)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _f32_acts(on: bool = True):
    """Within the block both packages' decoders embed float32 rows, so
    with float32 frames every activation is float32."""
    with pytest.MonkeyPatch.context() as mp:
        if on:
            mp.setattr(ref_encdec, "jnp", _F32Numpy())
            mp.setattr(encdec, "embed_tokens",
                       lambda cfg, params, tokens, prefix_embeds=None:
                       F.embedding(tokens.long(), params["embed"]))
        yield


def _perturb(tree, rng):
    """Every bias and every norm scale/bias plus N(0, 0.1) noise."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k.startswith("b") or k in ("scale", "bias"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


# the three activation modes: frames' dtype, float32 decoder embedding
MODES = {"bf16": ("bfloat16", False), "f32_frames": ("float32", False),
         "f32": ("float32", True)}


def _ref_grads(g):
    return {"/".join(k.key for k in path): _np(x)
            for path, x in jax.tree_util.tree_flatten_with_path(g)[0]}


def _ref_stream(ref_cfg, fns, jp, frames, acts, feed=None):
    """The reference's api.prefill and DECODE_STEPS api.decode_steps
    from token 0, greedy or fed `feed`'s tokens: [(token fed, logits)]
    a step, the prefilled cache's signature and the encoder output.
    `fns` holds the jitted prefill and step, shared by every call (the
    float32 activations' operands are float32, so their programs are
    traced under the patch and kept apart by dtype)."""
    prefill, step = fns
    with _f32_acts(acts == "float32"):
        dt = getattr(jnp, acts)
        cache = ref_api.init_cache(ref_cfg, B, T, dt)
        enc, cache = prefill(jp, {"frames": jnp.asarray(frames, dt)}, cache)
        sig = tree_signature(cache)
        tok = np.zeros(B, np.int32)
        out = []
        for i in range(DECODE_STEPS):
            if feed is not None:
                tok = feed[i][0]
            lg, cache = step(jp, cache, jnp.asarray(tok),
                             jnp.asarray(i, jnp.int32))
            out.append((tok.copy(), _np(lg)))
            tok = _np(lg).argmax(-1).astype(np.int32)
    return out, sig, _np(enc)


def tree_signature(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of arrays/tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_signature(tree[k], f"{path}/{k}"))
        return out
    dt = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), dt)}


# ----------------------------------------------------------------------
# the reference, once per module
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    ref_cfg, cfg = ref_reduced_config(ARCH), reduced_config(ARCH)
    rng = np.random.default_rng(0)
    npp = _perturb(jax.tree_util.tree_map(
        np.asarray, ref_api.init(ref_cfg, jax.random.PRNGKey(0))), rng)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = convert.from_reference(npp, cfg, device="cpu")
    frames = rng.standard_normal(
        (B, cfg.max_source_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    S = S_ENC[0]
    fwd = {}
    for mode, (fdt, f32) in MODES.items():
        batch = {"frames": jnp.asarray(frames[:, :S], getattr(jnp, fdt)),
                 "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        with _f32_acts(f32):
            enc = jax.jit(functools.partial(ref_encdec.encode, ref_cfg))(
                jp, batch["frames"])
            dec = jax.jit(functools.partial(ref_encdec.decode, ref_cfg))(
                jp, batch["tokens"], enc)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: ref_api.loss_fn(ref_cfg, p, batch)))(jp)
        fwd[mode] = dict(enc=enc, dec=dec, loss=float(loss),
                         grads=_ref_grads(g))
    served = {}
    fns = (jax.jit(functools.partial(ref_api.prefill, ref_cfg)),
           jax.jit(functools.partial(ref_api.decode_step, ref_cfg)))
    for S in S_ENC:
        run = functools.partial(_ref_stream, ref_cfg, fns, jp,
                                frames[:, :S])
        f32, sig, enc32 = run("float32")
        bf16, sig16, _ = run("bfloat16")
        # the reference's bf16 steps fed its float32 stream's tokens: its
        # own bf16 noise at each step
        fed, _, _ = run("bfloat16", feed=f32)
        noise = max(_steps(a[1], b[1]) for a, b in zip(f32, fed))
        served[S] = dict(float32=f32, bfloat16=bf16, sig=sig16, noise=noise,
                         sig32=sig, enc32=enc32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, jp=jp, tp=tp, frames=frames,
                toks=toks, labels=labels, fwd=fwd, served=served)


def _port_batch(r, mode, S=S_ENC[0]):
    fdt = getattr(torch, MODES[mode][0])
    return {"frames": torch.from_numpy(r["frames"][:, :S]).to(fdt),
            "tokens": torch.from_numpy(r["toks"]),
            "labels": torch.from_numpy(r["labels"])}


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def test_specs_match_the_reference(ref):
    """The same leaves with the same shapes and init rules, so the
    reference's tree bridges unchanged; the full-width count is ~0.24 B
    (51968 x 768 tied embedding included)."""
    ref_specs = ref_api.param_shapes(ref["ref_cfg"])
    flat = {"/".join(k.key for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                ref_specs, is_leaf=lambda x: hasattr(x, "shape"))[0]}
    port = dict(items_with_path(api.param_shapes(ref["cfg"])))
    assert sorted(port) == sorted(flat)
    for path, s in port.items():
        assert s.shape == tuple(flat[path].shape), path
        assert s.init == flat[path].init and s.scale == flat[path].scale
    full = get_config(ARCH)
    assert api.active_param_count(full) == ref_api.active_param_count(
        ref_get_config(ARCH))
    assert 0.2e9 < full.param_count() < 0.3e9
    tp = api.init(ref["cfg"], 0, device="cpu", dtype=torch.bfloat16)
    assert tp["enc_layers"]["ln1"]["scale"].dtype == torch.float32
    assert tp["dec_layers"]["cross_attn"]["wk"].dtype == torch.bfloat16


# ----------------------------------------------------------------------
# forward and loss
# ----------------------------------------------------------------------

def test_forward_and_loss_float32(ref):
    """Float32 activations: encoder, decoder and loss the reference's
    within float32 rounding."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    want = r["fwd"]["f32"]
    batch = _port_batch(r, "f32")
    with torch.no_grad(), _f32_acts():
        enc = encdec.encode(cfg, tp, batch["frames"])
        dec = encdec.decode(cfg, tp, batch["tokens"], enc)
        loss = api.loss_fn(cfg, tp, batch)
    assert enc.dtype == dec.dtype == torch.float32
    assert _steps(want["enc"], enc) <= F32_STEPS
    assert _steps(want["dec"], dec) <= F32_STEPS
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "f32_frames"])
def test_forward_and_loss(ref, mode):
    """bf16 frames (all bf16) and float32 frames (float32 encoder, bf16
    decoder): dtypes the reference's; the float32 encoder at float32
    rounding, bf16 outputs within max(MODEL_STEPS, NOISE x noise) of the
    reference's float32 ones, the loss within 5e-3."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    want, want32 = r["fwd"][mode], r["fwd"]["f32"]
    batch = _port_batch(r, mode)
    with torch.no_grad():
        enc = encdec.encode(cfg, tp, batch["frames"])
        dec = encdec.decode(cfg, tp, batch["tokens"], enc)
        loss = api.loss_fn(cfg, tp, batch)
    assert str(enc.dtype) == "torch." + str(want["enc"].dtype)
    assert dec.dtype == torch.bfloat16 and want["dec"].dtype == jnp.bfloat16
    if mode == "f32_frames":
        assert _steps(want["enc"], enc) <= F32_STEPS
    else:
        noise = _steps(want32["enc"], want["enc"])
        assert _steps(want32["enc"], enc) <= max(MODEL_STEPS, NOISE * noise)
    noise = _steps(want32["dec"], want["dec"])
    got = _steps(want32["dec"], dec)
    assert got <= max(MODEL_STEPS, NOISE * noise), (got, noise)
    assert abs(loss.item() - want["loss"]) <= 5e-3, (loss.item(),
                                                      want["loss"])


@pytest.mark.parametrize("enc_dtype", ["float32", "bfloat16"])
def test_cross_block_promotes_as_jax(ref, enc_dtype):
    """Cross-attention of bf16 decoder rows against a float32 (or bf16)
    encoder output: the port casts q, k, v to the promoted dtype, as
    JAX promotes k/v (float32 enc_out x bf16 weights) and its flash
    promotes q; within one bf16 step of the reference's block."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    e = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0],
                                 r["jp"]["dec_layers"]["cross_attn"])
    want = ref_encdec._cross_block(
        r["ref_cfg"], jlp, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(e, getattr(jnp, enc_dtype)))
    tlp = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    got = encdec._cross_block(
        cfg, tlp, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(e).to(getattr(torch, enc_dtype)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _steps(want, got) <= 1.0


@pytest.mark.parametrize("mode", list(MODES))
def test_gradients(ref, mode):
    """Every gradient leaf of loss_fn by the docstring's rules."""
    r, cfg = ref, ref["cfg"]
    tp = tree_map(lambda t: t.clone(), r["tp"])
    with _f32_acts(MODES[mode][1]):
        loss, grads = value_and_grad(cfg, tp, _port_batch(r, mode))
    want, ref32 = r["fwd"][mode]["grads"], r["fwd"]["f32"]["grads"]
    got = {k: g.float().numpy() for k, g in items_with_path(grads)}
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        scale = np.abs(ref32[key]).max()
        if key.endswith("attn/bk"):
            # exact gradient 0: rounding noise, held at its bq's scale
            scale = np.abs(ref32[key[:-2] + "bq"]).max()
        if mode == "f32":
            err = np.abs(g - want[key]).max()
            assert err <= F32_GRAD * scale, (key, err / scale)
        else:
            noise = np.abs(want[key] - ref32[key]).max()
            far = np.abs(g - ref32[key]).max()
            assert far <= NOISE * noise + 0.05 * scale, \
                (key, far / scale, noise / scale)


# ----------------------------------------------------------------------
# serving: prefill and greedy decode steps
# ----------------------------------------------------------------------

def _port_stream(cfg, tp, frames, acts, feed=None):
    """The port's api.prefill and api.decode_steps, as `_ref_stream`.
    Also returns the prefilled cache and the decode step's cache."""
    with _f32_acts(acts == "float32"):
        dt = getattr(torch, acts)
        cache = api.init_cache(cfg, B, T, dt, device="cpu")
        enc, cache = api.prefill(cfg, tp, {"frames": torch.from_numpy(
            frames).to(dt)}, cache)
        prefilled = tree_map(lambda t: t.clone(), cache)
        tok = torch.zeros(B, dtype=torch.int32)
        out = []
        for i in range(DECODE_STEPS):
            if feed is not None:
                tok = torch.from_numpy(feed[i][0])
            lg, cache = api.decode_step(cfg, tp, cache, tok, i)
            out.append((tok.numpy().copy(), lg))
            tok = lg.argmax(-1).to(torch.int32)
    return out, enc, prefilled, cache


@pytest.mark.parametrize("S", S_ENC)
def test_greedy_float32_equals_the_reference(ref, S):
    """Float32 activations: prefill's encoder output and cross K/V
    (exactly S_enc rows, the reference's shapes), then 12 greedy steps:
    the port's own tokens identical to the reference's at every step,
    logits within F32_STEPS."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    want = r["served"][S]
    got, enc, cache, _ = _port_stream(cfg, tp, r["frames"][:, :S],
                                      "float32")
    assert tree_signature(cache) == want["sig32"]
    assert cache["xk"].shape[2] == S
    assert _steps(want["enc32"], enc) <= F32_STEPS
    for i, ((wt, wl), (gt, gl)) in enumerate(zip(want["float32"], got)):
        assert np.array_equal(wt, gt), i
        assert _steps(wl, gl) <= F32_STEPS, i


@pytest.mark.parametrize("S", S_ENC)
def test_greedy_bf16_against_the_reference(ref, S):
    """bf16 (the shipped path): the cache's tree, shapes and dtypes the
    reference's; fed the reference's tokens, every step's logits within
    max(MODEL_STEPS, NOISE x noise) of the reference's bf16 logits; the
    port's own greedy tokens equal the reference's at every step until
    one where the reference's top-2 margin is within that bar (a tie in
    bf16 can go either way)."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    want = r["served"][S]
    bar = max(MODEL_STEPS, NOISE * want["noise"])
    fed, _, cache, _ = _port_stream(cfg, tp, r["frames"][:, :S],
                                    "bfloat16", feed=want["bfloat16"])
    assert tree_signature(cache) == want["sig"]
    for i, ((_, wl), (_, gl)) in enumerate(zip(want["bfloat16"], fed)):
        assert gl.dtype == torch.bfloat16
        assert _steps(wl, gl) <= bar, i
    own, _, _, _ = _port_stream(cfg, tp, r["frames"][:, :S], "bfloat16")
    for i, ((wt, wl), (gt, _)) in enumerate(zip(want["bfloat16"], own)):
        if not np.array_equal(wt, gt):
            top2 = np.sort(wl, -1)[:, -2:]
            margin = (top2[:, 1] - top2[:, 0]).min()
            assert margin <= bar * 2.0 ** -7 * np.abs(wl).max(), (i, margin)
            break


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_cross_kv_rows_past_the_encoder_are_never_attended(ref, acts):
    """S_enc = 24 < max_source_len 32: prefill fills 24 rows of the
    32-row cross buffers in place and hands the decode step views of
    exactly those rows (the reference's arrays of S_enc rows).  With the
    buffer's rows past them poisoned (NaN), the step's logits are the
    unpoisoned step's bit for bit and the reference's within its bar,
    where a step over the whole buffer reads the poison."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    S = S_ENC[0]
    dt = getattr(torch, acts)
    with _f32_acts(acts == "float32"):
        buf = api.init_cache(cfg, B, T, dt, device="cpu")
        _, cache = api.prefill(cfg, tp, {"frames": torch.from_numpy(
            r["frames"][:, :S]).to(dt)}, buf)
        assert cache["xk"].data_ptr() == buf["xk"].data_ptr()
        assert cache["xk"].shape[2] == S and buf["xk"].shape[2] == 32
        assert not buf["xk"][:, :, S:].any() and buf["xk"][:, :, :S].any()
        tok = torch.zeros(B, dtype=torch.int32)
        clean, _ = api.decode_step(cfg, tp, tree_map(
            lambda t: t.clone(), cache), tok, 0)
        for leaf in (buf["xk"], buf["xv"]):
            leaf[:, :, S:] = float("nan")
        right, _ = api.decode_step(cfg, tp, tree_map(
            lambda t: t.clone(), cache), tok, 0)
        whole, _ = api.decode_step(cfg, tp, buf, tok, 0)
    want = r["served"][S][acts][0][1]
    bar = (F32_STEPS if acts == "float32"
           else max(MODEL_STEPS, NOISE * r["served"][S]["noise"]))
    assert torch.equal(right, clean)
    assert _steps(want, right) <= bar
    assert not torch.isfinite(whole.float()).all()
    with pytest.raises(ValueError, match="cross K/V"):
        api.prefill(cfg, tp, {"frames": torch.zeros(
            B, S + 1, cfg.d_model, dtype=dt)}, cache)


@pytest.mark.parametrize("acts", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_steps(ref, acts):
    """encdec.decode over the fed tokens, read out at every position,
    against the step-by-step logits (flash attention against the cached
    decode attention): float32 within F32_STEPS, bf16 within the bar."""
    r, cfg, tp = ref, ref["cfg"], ref["tp"]
    S = S_ENC[1]
    want = r["served"][S]
    steps, enc, _, _ = _port_stream(cfg, tp, r["frames"][:, :S], acts,
                                    feed=want["float32"])
    toks = torch.from_numpy(np.stack([t for t, _ in steps], 1))
    with torch.no_grad(), _f32_acts(acts == "float32"):
        h = encdec.decode(cfg, tp, toks, enc)
        rows = (h @ tp["embed"].T.to(h.dtype))[..., :cfg.vocab_size]
    rows = rows.float().numpy()
    bar = (F32_STEPS if acts == "float32"
           else max(MODEL_STEPS, NOISE * want["noise"]))
    for i, (_, lg) in enumerate(steps):
        assert _steps(rows[:, i], lg) <= bar, i


def test_decode_step_clamps_and_refuses_serving_options(ref):
    """pos past max_target_len - 1 is clamped (the last position's
    logits); the cache defaults to the family's own, and the paged /
    fp8 / kernel / block-table options and the chunk, verify and COW
    paths refuse encdec, naming the family."""
    cfg, tp = ref["cfg"], ref["tp"]
    cache = api.init_cache(cfg, B, 1000, device="cpu")
    assert cache["k"].shape[2] == cfg.max_target_len
    _, cache = api.prefill(cfg, tp, {"frames": torch.zeros(
        B, 8, cfg.d_model, dtype=torch.bfloat16)}, cache)
    tok = torch.zeros(B, dtype=torch.int32)
    a, _ = api.decode_step(cfg, tp, tree_map(lambda t: t.clone(), cache),
                           tok, cfg.max_target_len - 1)
    b, _ = api.decode_step(cfg, tp, tree_map(lambda t: t.clone(), cache),
                           tok, torch.tensor(cfg.max_target_len + 5))
    assert torch.equal(a, b)
    for call in (
            lambda: api.init_cache(cfg, B, T, paged=True, device="cpu"),
            lambda: api.init_cache(cfg, B, T, fp8_kv=True, device="cpu"),
            lambda: api.decode_step(cfg, tp, cache, tok, 0, kernel=True),
            lambda: api.decode_step(cfg, tp, cache, tok, 0,
                                    torch.zeros(B, 1, dtype=torch.int32)),
            lambda: api.chunk_step(cfg, tp, cache, tok[:, None], 0,
                                   torch.ones(B, dtype=torch.int32)),
            lambda: api.verify_step(cfg, tp, cache, tok[:, None], 0),
            lambda: api.cow_copy_block(cfg, cache, 0, 1)):
        with pytest.raises(NotImplementedError, match="encdec"):
            call()


# ----------------------------------------------------------------------
# shape cells
# ----------------------------------------------------------------------

CELL_ARCHS = ("whisper-small", "yi-6b", "moonshot-v1-16b-a3b",
              "internvl2-1b", "falcon-mamba-7b", "zamba2-2.7b")
CELLS = dict(SHAPES, train_whisper=ShapeConfig("train_whisper", 3000, 4,
                                               "train"),
             prefill_30s=ShapeConfig("prefill_30s", 1500, 8, "prefill"),
             decode_448=ShapeConfig("decode_448", 448, 8, "decode"))


def _ref_cell(name, cell):
    return REF_SHAPES.get(name) or RefShapeConfig(
        cell.name, cell.seq_len, cell.global_batch, cell.kind)


def _spec_sig(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_shape_cells_match_the_reference(arch):
    """input_specs, cache_specs and model_flops of every cell equal the
    reference's (shapes, dtypes, FLOPs) at full width, on the meta
    device."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name, cell in CELLS.items():
        rcell = _ref_cell(name, cell)
        specs = api.input_specs(cfg, cell)
        assert all(s.device.type == "meta" for s in specs.values())
        assert _spec_sig(specs) == _spec_sig(ref_api.input_specs(ref_cfg,
                                                                 rcell))
        assert tree_signature(api.cache_specs(cfg, cell)) == tree_signature(
            ref_api.cache_specs(ref_cfg, rcell)), (arch, name)
        assert api.model_flops(cfg, cell) == ref_api.model_flops(ref_cfg,
                                                                 rcell)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b", "yi-6b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_the_reference(arch, kind):
    """make_batch at a reduced config: the reference's keys, shapes,
    dtypes and value ranges (token ids in [0, vocab), normal floats,
    the scalar pos its value); seeded: the same seed the same batch."""
    cfg, ref_cfg = reduced_config(arch), ref_reduced_config(arch)
    cell = ShapeConfig("c", 40, 3, kind)
    rcell = RefShapeConfig("c", 40, 3, kind)
    got = api.make_batch(cfg, cell, 7, device="cpu")
    want = ref_api.make_batch(ref_cfg, rcell, jax.random.PRNGKey(7))
    assert _spec_sig(got) == _spec_sig(want)
    for k, v in got.items():
        w = want[k]
        if v.dtype == torch.int32 and v.ndim:
            hi = cfg.vocab_size
            assert 0 <= int(v.min()) and int(v.max()) < hi, k
            assert int(_np(w).max()) < hi
        elif v.dtype == torch.int32:
            assert int(v) == int(w), k
        else:
            vf = v.float()
            assert torch.isfinite(vf).all() and 0.5 < vf.std() < 1.5, k
    again = api.make_batch(cfg, cell, 7, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    if cfg.family == "encdec" and kind != "decode":
        assert got["frames"].shape[1] == min(40, cfg.max_source_len)


def test_whisper_batch_runs_through_api(ref):
    """A make_batch train cell of the reduced whisper through
    api.loss_fn (finite, near ln(vocab) at random weights) and a prefill
    cell through api.prefill."""
    cfg, tp = ref["cfg"], ref["tp"]
    batch = api.make_batch(cfg, ShapeConfig("t", 24, 2, "train"), 0,
                           device="cpu")
    with torch.no_grad():
        loss = api.loss_fn(cfg, tp, batch)
    assert torch.isfinite(loss) and abs(loss.item() - np.log(
        cfg.padded_vocab_size)) < 1.0
    cell = ShapeConfig("p", 40, 2, "prefill")
    pre = api.make_batch(cfg, cell, 1, device="cpu")
    cache = api.init_cache(cfg, 2, T, device="cpu")
    enc, cache = api.prefill(cfg, tp, pre, cache)
    assert enc.shape == (2, cfg.max_source_len, cfg.d_model)
    assert tree_signature(cache) == tree_signature(api.cache_specs(
        cfg, dataclasses.replace(cell, seq_len=T)))
