"""Functional BigBird encoder in PyTorch (HF ``BigBirdModel`` semantics).

The port of the JAX package's ``stonkgs_tpu/models/bigbird.py``, the trunk
of ProtSTonKGs.  Differences from BERT kept on purpose:

* the embeddings apply dropout BEFORE LayerNorm, with an optional
  sqrt(hidden) rescale;
* attention is ``original_full`` (dense, as BERT, -1e9 key bias) or
  ``block_sparse`` (:mod:`stonkgs_tpu_torch.ops.bigbird_sparse`, penalty
  -10000); HF falls back to full attention when seq_len <= (5 + 2r) ·
  block_size, and so does :func:`effective_attention_type`;
* block-sparse attention has no attention-probability dropout, as in the
  JAX package;
* the pooler is dense + tanh on the first token.

Inference runs the post-attention half of every full layer through the
fused LN1 -> FFN -> LN2 kernel (``gelu_new``); training runs the training
FFN kernel pair with explicit dropouts and LayerNorms between them; a
layer with quantized FFN leaves runs them unfused through the int8 dense
(``models/bert.py::ffn_half``).  The encoder is a list of layer dicts;
the per-layer random plan (see
:func:`stonkgs_tpu_torch.ops.bigbird_sparse.build_rand_attn`) is indexed
by the loop.  Layer remat as in ``models/bert.py``: "full" checkpoints
each layer, "attention" its attention sub-block (the JAX package's
``bigbird.py:221-224``, ``:308-312``), with the same dropout in the
recompute as in the forward.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.config import BigBirdConfig
from stonkgs_tpu_torch.models.bert import (
    DropoutRng,
    _init_dense,
    _init_layer_norm,
    _trunc_normal,
    activation,
    attention_bias_from_mask,
    dense,
    dropout,
    layer_norm,
    remat_layer,
    remat_mode,
)
from stonkgs_tpu_torch.ops.attention import dot_product_attention, plain_attention
from stonkgs_tpu_torch.ops.bigbird_sparse import (
    ATTN_PENALTY,
    block_sparse_attention,
    build_rand_attn,
    plan_to_device,
)


def init_bigbird_params(gen: torch.Generator, cfg: BigBirdConfig,
                        with_pooler: bool = True) -> dict:
    """A BigBirdModel parameter tree on the CPU, fp32, drawn from ``gen``;
    ``encoder`` is a list of layer dicts.  Without ``cfg.use_bias`` the
    query, key and value projections have no bias."""
    h, i, std = cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range
    params = {
        "embeddings": {
            "word_embeddings": _trunc_normal(gen, (cfg.vocab_size, h), std),
            "position_embeddings": _trunc_normal(gen, (cfg.max_position_embeddings, h), std),
            "token_type_embeddings": _trunc_normal(gen, (cfg.type_vocab_size, h), std),
            "layer_norm": _init_layer_norm(h),
        },
    }

    def init_layer():
        lp = {
            "attention": {
                "query": _init_dense(gen, h, h, std),
                "key": _init_dense(gen, h, h, std),
                "value": _init_dense(gen, h, h, std),
                "output": _init_dense(gen, h, h, std),
                "output_layer_norm": _init_layer_norm(h),
            },
            "intermediate": _init_dense(gen, h, i, std),
            "output": _init_dense(gen, i, h, std),
            "output_layer_norm": _init_layer_norm(h),
        }
        if not cfg.use_bias:
            for name in ("query", "key", "value"):
                lp["attention"][name].pop("bias")
        return lp

    params["encoder"] = [init_layer() for _ in range(cfg.num_hidden_layers)]
    if with_pooler:
        params["pooler"] = _init_dense(gen, h, h, std)
    return params


def embed(
    params: dict,
    cfg: BigBirdConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BigBirdEmbeddings: word (or inputs, optionally rescaled) + token
    type + position, dropout, THEN LayerNorm."""
    p = params["embeddings"]
    if inputs_embeds is None:
        inputs_embeds = p["word_embeddings"][input_ids]
    x = inputs_embeds.to(compute_dtype)
    if cfg.rescale_embeddings:
        x = x * (cfg.hidden_size ** 0.5)
    device = x.device
    if position_ids is None:
        position_ids = torch.arange(x.shape[-2], device=device)[None, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros(x.shape[:-1], dtype=torch.int64, device=device)
    x = x + p["token_type_embeddings"][token_type_ids].to(compute_dtype)
    x = x + p["position_embeddings"][position_ids].to(compute_dtype)
    x = dropout(x, cfg.hidden_dropout_prob, rng, deterministic)
    return layer_norm(x, p["layer_norm"], cfg.layer_norm_eps)


def effective_attention_type(cfg: BigBirdConfig, seq_len: int) -> str:
    """HF's fallback: block-sparse needs seq_len > (5 + 2r) · block_size."""
    if cfg.attention_type == "block_sparse":
        if seq_len <= (5 + 2 * cfg.num_random_blocks) * cfg.block_size:
            return "original_full"
        return "block_sparse"
    return "original_full"


@functools.lru_cache(maxsize=8)
def _default_plan(seq_len: int, cfg: BigBirdConfig, training: bool) -> np.ndarray:
    """The model's (L, H, nb-2, r) plan for one mode (a constant: HF
    reseeds every forward), built once."""
    plan = build_rand_attn(seq_len, cfg.block_size, cfg.num_random_blocks,
                           cfg.num_attention_heads, cfg.num_hidden_layers,
                           cfg.max_position_embeddings, training=training)
    plan.setflags(write=False)
    return plan


def _attention(x, ap, cfg, attn_type, mask_f, attn_bias, plan, deterministic, seed):
    """The attention sub-block up to its output projection; ``seed`` is
    the dense attention's two-word dropout seed (None without dropout)."""
    B, S, H = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    q = dense(x, ap["query"]).reshape(B, S, nh, hd)
    k = dense(x, ap["key"]).reshape(B, S, nh, hd)
    v = dense(x, ap["value"]).reshape(B, S, nh, hd)
    if attn_type == "block_sparse":
        ctx = block_sparse_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     plan, mask_f, cfg.block_size).transpose(1, 2)
    else:
        ctx = dot_product_attention(q, k, v, attn_bias, deterministic=deterministic,
                                    dropout_rate=cfg.attention_probs_dropout_prob, seed=seed)
    return dense(ctx.reshape(B, S, H), ap["output"])


def _layer(x, lp, cfg, attn_type, mask_f, attn_bias, plan, deterministic, rng, remat):
    """One post-LN BigBird layer (``stonkgs_tpu/models/bigbird.py:178-268``);
    its post-attention half is BERT's (fused, or unfused for quantized
    FFN leaves).  ``remat`` checkpoints the layer ("full") or its
    attention sub-block ("attention") where gradients flow; block-sparse
    attention has no dropout and draws no seed."""
    dense_dropout = not (deterministic or rng is None or attn_type == "block_sparse")
    seed = rng.attention_seed() if dense_dropout else None
    return remat_layer(
        lambda x: _attention(x, lp["attention"], cfg, attn_type, mask_f, attn_bias, plan,
                             deterministic, seed),
        x, lp, cfg, deterministic, rng, remat)


def _layer_cls(x, lp, cfg, attn_type, mask_f, attn_bias):
    """The last layer at the [CLS] query only, in plain torch.  Under
    block-sparse, row 0 is a dense full row with the -10000 penalty and a
    query-mask multiply (the first query block attends everything)."""
    B, S, H = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    ap = lp["attention"]
    x0 = x[:, :1]
    q = dense(x0, ap["query"]).reshape(B, 1, nh, hd)
    k = dense(x, ap["key"]).reshape(B, S, nh, hd)
    v = dense(x, ap["value"]).reshape(B, S, nh, hd)
    if attn_type == "block_sparse":
        ctx = plain_attention(q, k, v, ((1.0 - mask_f) * ATTN_PENALTY)[:, None, None, :])
        ctx = ctx * mask_f[:, :1, None, None].to(ctx.dtype)
    else:
        ctx = plain_attention(q, k, v, attn_bias)
    attn_out = dense(ctx.reshape(B, 1, H), ap["output"])
    x0 = layer_norm(x0 + attn_out, ap["output_layer_norm"], cfg.layer_norm_eps)
    ff = dense(activation(cfg.hidden_act)(dense(x0, lp["intermediate"])), lp["output"])
    return layer_norm(x0 + ff, lp["output_layer_norm"], cfg.layer_norm_eps)


def bigbird_model(
    params: dict,
    cfg: BigBirdConfig,
    input_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat=False,
    with_pooler: bool = True,
    rand_attn=None,                         # (L, H, nb-2, r) plan
    attention_type: Optional[str] = None,   # overrides cfg.attention_type
    cls_only: bool = False,                 # last layer at [CLS] only
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full BigBirdModel forward: (sequence_output, pooled | None).

    Without ``rand_attn`` the block-sparse layers use HF's plan for the
    mode: all zeros in inference, the seeded training plan otherwise.
    ``cls_only`` (inference only) computes the last layer for the [CLS]
    query alone and returns a (B, 1, H) sequence output.  ``remat`` is
    one of :func:`~stonkgs_tpu_torch.models.bert.remat_mode`'s values."""
    mode = remat_mode(remat)
    if cls_only and not deterministic:
        raise ValueError("cls_only is an inference-path optimization")
    hidden = embed(params, cfg, input_ids=input_ids, inputs_embeds=inputs_embeds,
                   token_type_ids=token_type_ids, deterministic=deterministic, rng=rng,
                   compute_dtype=compute_dtype)
    B, S, _ = hidden.shape
    if attention_type is not None:
        cfg_eff = dataclasses.replace(cfg, attention_type=attention_type)
    else:
        cfg_eff = cfg
    attn_type = effective_attention_type(cfg_eff, S)
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask_f = attention_mask.to(torch.float32)

    layers = params["encoder"]
    plan = [None] * len(layers)
    attn_bias = None
    if attn_type == "block_sparse":
        if S % cfg.block_size:
            raise ValueError(f"seq len {S} is not a multiple of the block size "
                             f"{cfg.block_size}")
        if rand_attn is None:
            rand_attn = _default_plan(S, cfg, not deterministic)
        plan = plan_to_device(rand_attn, S // cfg.block_size, hidden.device)
    else:
        attn_bias = attention_bias_from_mask(mask_f)

    body = layers[:-1] if cls_only else layers
    x = hidden
    for i, lp in enumerate(body):
        x = _layer(x, lp, cfg, attn_type, mask_f, attn_bias, plan[i], deterministic, rng,
                   mode)
    if cls_only:
        x = _layer_cls(x, layers[-1], cfg, attn_type, mask_f, attn_bias)
    pooled = None
    if with_pooler and "pooler" in params:
        pooled = torch.tanh(dense(x[:, 0], params["pooler"]))
    return x, pooled
