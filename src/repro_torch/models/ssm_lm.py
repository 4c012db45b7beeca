"""Attention-free SSM language model (falcon-mamba-7b: a Mamba-1 stack).

PyTorch counterpart of ``repro/models/ssm_lm.py``.  Layer parameters
keep the reference's stacked layout (a leading [L] axis); its scans
over layers are Python loops over layer slices.  Serving keeps a
recurrent state instead of a KV cache: {"ssm": [L, B, d_inner, N]
float32, "conv": [L, B, W-1, d_inner]}, updated in place by
``decode_step`` and ``prefill``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec, apply_norm, norm_spec
from repro_torch.models.transformer import (_embed, _remat, embed_tokens,
                                            layer_list, layer_slice,
                                            lm_xent, logits_fn, stack_specs)

Params = Dict[str, Any]


def ssm_lm_specs(cfg) -> Params:
    layer = {"ln": norm_spec(cfg, cfg.d_model),
             "mixer": ssm.mamba1_specs(cfg)}
    specs: Params = {
        "embed": ParamSpec((cfg.padded_vocab_size, cfg.d_model),
                           ("vocab", "embed"), scale=0.02),
        "layers": stack_specs(layer, cfg.num_layers),
        "final_norm": norm_spec(cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab_size),
                                     ("embed", "vocab"))
    return specs


def _block(cfg, lp, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, lp["ln"])
    y, _ = ssm.mamba1_mixer(cfg, lp["mixer"], h)
    return x + y


def forward(cfg, params, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (final hidden [B,S,d], zero aux loss); each layer
    under the config's remat policy."""
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    blk = _remat(cfg, functools.partial(_block, cfg))
    for lp in layer_list(params["layers"], cfg.num_layers):
        x = blk(lp, x)
    x = apply_norm(cfg, x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    h, _ = forward(cfg, params, batch["tokens"])
    return lm_xent(cfg, params, h, batch["labels"])


def _sharded_block(cfg, g, lp, xd, read):
    h = T.norm(cfg, g, lp["ln"], xd, read)
    y = ssm.sharded_mamba1(cfg, lp["mixer"], g, h, read)
    return {d: xd[d] + y[d] for d in g.devices}


def sharded_loss_fn(cfg, params, batch: Dict[str, torch.Tensor], mesh,
                    plan) -> torch.Tensor:
    """`loss_fn` over a mesh (transformer.sharded_lm_loss): each layer's
    d_inner channels over `model` (ssm.sharded_mamba1)."""
    unit = T.per_group(functools.partial(_sharded_block, cfg))
    return T.sharded_lm_loss(cfg, params, batch, mesh, plan,
                             [(unit, lp) for lp in layer_list(
                                 params["layers"], cfg.num_layers)])


# --- serving: recurrent state instead of a KV cache ---------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """`max_len` is irrelevant for an SSM: its state is O(1) in context."""
    del max_len
    st = ssm.mamba1_state(cfg, batch, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + v.shape, dtype=v.dtype,
                           device=v.device) for k, v in st.items()}


def _stack_step(cfg, params, cache: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """Every layer over x [B,S,d] from the cache's state, which each
    layer's new state overwrites; then the final norm."""
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        st = {k: leaf[i] for k, leaf in cache.items()}
        h = apply_norm(cfg, x, lp["ln"])
        y, new = ssm.mamba1_mixer(cfg, lp["mixer"], h, state=st)
        for k in st:
            st[k].copy_(new[k])
        x = x + y
    return apply_norm(cfg, x, params["final_norm"])


def decode_step(cfg, params, cache: Params, token: torch.Tensor, pos
                ) -> Tuple[torch.Tensor, Params]:
    """One token a sequence (token [B]); SSM decode is position-free.
    Returns (logits [B, vocab], cache), the cache updated in place."""
    del pos
    x = _embed(params, token)[:, None, :]
    x = _stack_step(cfg, params, cache, x)
    return logits_fn(cfg, params, x)[:, 0], cache


def prefill(cfg, params, tokens: torch.Tensor, cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt through the recurrence from the cache's state
    (from a zero state: the arithmetic of `forward`), leaving the final
    state in the cache.  Returns (last-position logits, cache)."""
    x = embed_tokens(cfg, params, tokens)
    x = _stack_step(cfg, params, cache, x)
    return logits_fn(cfg, params, x[:, -1:])[:, 0], cache
