"""Functional BERT encoder in PyTorch, for serving and training.

The port of the JAX package's ``stonkgs_tpu/models/bert.py``: HF
``BertModel`` semantics (post-LayerNorm, erf-gelu, LayerNorm eps 1e-12,
tanh pooler on the first token).  Parameters are plain dicts of tensors
with the JAX layouts (dense kernels ``(in, out)``); the encoder is a list
of per-layer dicts run by a Python loop where the JAX package scans over
stacked layers.

Inference (``deterministic=True``): the post-attention half of every full
layer runs through
:func:`stonkgs_tpu_torch.ops.fused_ffn.fused_ffn_ln_block`, and its
attention through the port's inference attention kernel; the ``cls_only``
last layer stays plain torch, as in the JAX package.

Int8 serving: a dense leaf quantized by
:func:`stonkgs_tpu_torch.ops.quantization.quantize_params` (it holds
``kernel_q``) runs the int8 dense kernel; a layer whose FFN leaves are
quantized runs its post-attention half unfused, LN(x + attn) -> int8
dense -> gelu -> int8 dense -> LN(x + ff), as the JAX package does when
its FFN leaves hold no ``kernel``.

Training (``deterministic=False`` with a :class:`DropoutRng`): attention
runs the training kernel pair with its in-kernel hash dropout, the FFN
the training FFN kernel pair, and the hidden-state dropouts and
LayerNorms sit between them in the JAX order.

Layer remat (``remat``, the JAX package's modes): "full" checkpoints each
trunk layer and "attention" only its attention sub-block (Q/K/V, the
attention, the output projection) with ``torch.utils.checkpoint``, so
the backward recomputes them from the layer's input; "unroll", a
scan-versus-loop distinction in JAX, is "none" here, where the loop is
unrolled already.  The recompute draws the same dropout as the forward:
a region's attention seed is drawn before it and passed in, and the
device generator of the hidden-state masks is set back to its state at
the region's start for the recompute (and restored after it), so a
remat step equals a step without remat and leaves the generators where
that step leaves them.  Only regions that gradients flow through are
checkpointed; the frozen backbones run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stonkgs_tpu_torch.config import BertConfig
from stonkgs_tpu_torch.ops.attention import dot_product_attention, plain_attention
from stonkgs_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_ln_block
from stonkgs_tpu_torch.ops.quantization import dense_int8, is_quantized

NEG_INF = -1e9  # additive attention bias for masked positions


@dataclasses.dataclass
class DropoutRng:
    """The random streams of one training forward.

    Hidden-state dropout masks come from ``device``, a generator on the
    activations' device.  Each attention call's two-word int32 dropout
    seed comes from ``host``, a CPU generator, so the hash mask is the same
    whichever device runs the kernel.  Under a mesh both are seeded per
    data shard (:func:`stonkgs_tpu_torch.train.pretraining.step_rng`): the
    ranks of one data index draw the same masks, so the replicated trunk
    stays equal across the model axis."""

    device: torch.Generator
    host: torch.Generator

    def attention_seed(self) -> torch.Tensor:
        """Two int32 words for one attention call's hash dropout."""
        return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                             generator=self.host)


REMAT_MODES = ("none", "full", "attention", "unroll")


def remat_mode(remat) -> str:
    """The JAX package's ``remat`` values as a mode: False, None, "none"
    and "unroll" are "none" (the port's layer loop is unrolled already),
    True and "full" are "full", "attention" is "attention"; anything else
    raises ``ValueError``."""
    if remat in (False, None, "none", "unroll"):
        return "none"
    if remat is True or remat == "full":
        return "full"
    if remat == "attention":
        return "attention"
    raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}, True or False")


def checkpointed(fn: Callable, x: torch.Tensor, rng: Optional[DropoutRng]) -> torch.Tensor:
    """``fn(x)`` under ``torch.utils.checkpoint``, its intermediates
    recomputed in the backward.  ``fn`` draws its hidden-state dropout
    masks from ``rng.device``; the recompute starts that generator from
    its state at the forward's start and gives it back as it found it, so
    the masks match the forward's and no later draw shifts.  Attention
    seeds (``rng.host``) must be drawn by the caller and bound into
    ``fn``.  The region uses no default generator, so its state is not
    saved."""
    if rng is None:
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
    start = rng.device.get_state()
    recompute = False

    def run(x):
        nonlocal recompute
        if not recompute:
            recompute = True
            return fn(x)
        now = rng.device.get_state()
        rng.device.set_state(start)
        try:
            return fn(x)
        finally:
            rng.device.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """y = x @ kernel + bias, kernel (in, out), both used in ``x.dtype``.

    A leaf quantized by :func:`stonkgs_tpu_torch.ops.quantization.
    quantize_params` (it holds ``kernel_q``) goes to the int8 dense."""
    if is_quantized(p):
        return dense_int8(x, p)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; statistics in >= fp32, result in x.dtype."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(f) + p["bias"].to(f)).to(x.dtype)


def activation(name: str):
    """Resolve an HF activation name to its torch function."""
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported activation: {name}")


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with a mask from ``rng.device``; the identity when
    deterministic, at rate 0 or without an rng (as the JAX package)."""
    if deterministic or rate == 0.0 or rng is None:
        return x
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter initialization
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    # truncated at two standard deviations, as the JAX package's init
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=gen)


def _init_dense(gen, d_in, d_out, std) -> dict:
    return {"kernel": _trunc_normal(gen, (d_in, d_out), std),
            "bias": torch.zeros(d_out)}


def _init_layer_norm(dim) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def init_layer_params(gen: torch.Generator, cfg: BertConfig) -> dict:
    """One encoder layer."""
    h, i, std = cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range
    return {
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


def init_embedding_params(gen: torch.Generator, cfg: BertConfig) -> dict:
    """The word, position and token-type tables and their LayerNorm."""
    h, std = cfg.hidden_size, cfg.initializer_range
    return {
        "word_embeddings": _trunc_normal(gen, (cfg.vocab_size, h), std),
        "position_embeddings": _trunc_normal(gen, (cfg.max_position_embeddings, h), std),
        "token_type_embeddings": _trunc_normal(gen, (cfg.type_vocab_size, h), std),
        "layer_norm": _init_layer_norm(h),
    }


def init_bert_params(gen: torch.Generator, cfg: BertConfig,
                     with_pooler: bool = True) -> dict:
    """A full BertModel parameter tree on the CPU, fp32, drawn from ``gen``
    (a CPU ``torch.Generator``); ``encoder`` is a list of layer dicts."""
    h, std = cfg.hidden_size, cfg.initializer_range
    params = {
        "embeddings": init_embedding_params(gen, cfg),
        "encoder": [init_layer_params(gen, cfg)
                    for _ in range(cfg.num_hidden_layers)],
    }
    if with_pooler:
        params["pooler"] = _init_dense(gen, h, h, std)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed(
    params: dict,
    cfg: BertConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BertEmbeddings: word/inputs + position + token-type, LayerNorm,
    dropout.

    With ``inputs_embeds`` the position and token-type embeddings are still
    added: this is how the STonKGs trunk consumes backbone embeddings."""
    p = params["embeddings"]
    if inputs_embeds is None:
        inputs_embeds = p["word_embeddings"][input_ids]
    inputs_embeds = inputs_embeds.to(compute_dtype)
    seq_len = inputs_embeds.shape[-2]
    device = inputs_embeds.device
    if position_ids is None:
        position_ids = torch.arange(seq_len, device=device)[None, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros(inputs_embeds.shape[:-1],
                                     dtype=torch.int64, device=device)
    pos = p["position_embeddings"][position_ids].to(compute_dtype)
    tok = p["token_type_embeddings"][token_type_ids].to(compute_dtype)
    x = inputs_embeds + pos + tok
    x = layer_norm(x, p["layer_norm"], cfg.layer_norm_eps)
    return dropout(x, cfg.hidden_dropout_prob, rng, deterministic)


def attention_bias_from_mask(attention_mask: Optional[torch.Tensor],
                             dtype=torch.float32) -> Optional[torch.Tensor]:
    """(B, S) 1/0 mask -> (B, 1, 1, S) additive bias (0 keep, -1e9 drop)."""
    if attention_mask is None:
        return None
    bias = (1.0 - attention_mask.to(dtype)) * NEG_INF
    return bias[:, None, None, :]


def encoder_layer(
    x: torch.Tensor,
    lp: dict,
    cfg: BertConfig,
    attn_bias: Optional[torch.Tensor],
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    remat: str = "none",
) -> torch.Tensor:
    """One post-LN BERT layer.

    Inference: the post-attention half is the fused LN1 -> FFN -> LN2
    block.  Training, in the JAX order (``stonkgs_tpu/models/bert.py:
    316-337``): attention output -> dropout -> LN(x + attn) -> fused FFN
    -> dropout -> LN(x + ff).  A layer whose FFN leaves are quantized
    (no ``kernel``) runs that unfused order with two :func:`dense` calls
    around the activation, in inference too, as the JAX package.

    ``remat`` ("none", "full" or "attention", see :func:`remat_mode`)
    checkpoints the layer or its attention sub-block where gradients
    flow."""
    seed = None if deterministic or rng is None else rng.attention_seed()
    return remat_layer(
        lambda x: attention_block(x, lp["attention"], cfg, attn_bias, deterministic, seed),
        x, lp, cfg, deterministic, rng, remat)


def remat_layer(attention: Callable, x: torch.Tensor, lp: dict, cfg, deterministic: bool,
                rng: Optional[DropoutRng], remat: str) -> torch.Tensor:
    """``attention(x)`` (which draws no mask; its seed is bound in) and the
    layer's :func:`ffn_half`, the whole layer under :func:`checkpointed`
    for ``remat="full"`` and the attention alone for "attention", where
    gradients flow (no checkpoint under ``torch.no_grad()``)."""
    if not torch.is_grad_enabled():
        remat = "none"

    def layer(x):
        attn_out = checkpointed(attention, x, None) if remat == "attention" else attention(x)
        return ffn_half(x, attn_out, lp, cfg, deterministic, rng)

    return checkpointed(layer, x, rng) if remat == "full" else layer(x)


def attention_block(x: torch.Tensor, ap: dict, cfg: BertConfig,
                    attn_bias: Optional[torch.Tensor], deterministic: bool,
                    seed: Optional[torch.Tensor]) -> torch.Tensor:
    """Q/K/V projections, attention with the two-word dropout ``seed``
    (None without dropout), and the output projection: the sub-block
    that ``remat="attention"`` checkpoints."""
    B, S, H = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    q = dense(x, ap["query"]).reshape(B, S, nh, hd)
    k = dense(x, ap["key"]).reshape(B, S, nh, hd)
    v = dense(x, ap["value"]).reshape(B, S, nh, hd)
    ctx = dot_product_attention(q, k, v, attn_bias, deterministic=deterministic,
                                dropout_rate=cfg.attention_probs_dropout_prob,
                                seed=seed)
    return dense(ctx.reshape(B, S, H), ap["output"])


def ffn_half(x: torch.Tensor, attn_out: torch.Tensor, lp: dict, cfg, deterministic: bool,
             rng: Optional[DropoutRng]) -> torch.Tensor:
    """The post-attention half of a layer: LN(x + attn) -> FFN -> LN(x + ff),
    fused in inference and as the training FFN pair when both FFN leaves
    hold ``kernel``, else (quantized leaves) two :func:`dense` calls."""
    ap = lp["attention"]
    fusable = "kernel" in lp["intermediate"] and "kernel" in lp["output"]
    if deterministic and fusable:
        return fused_ffn_ln_block(
            x, attn_out,
            ap["output_layer_norm"]["scale"], ap["output_layer_norm"]["bias"],
            lp["intermediate"]["kernel"], lp["intermediate"]["bias"],
            lp["output"]["kernel"], lp["output"]["bias"],
            lp["output_layer_norm"]["scale"], lp["output_layer_norm"]["bias"],
            act=cfg.hidden_act, eps=cfg.layer_norm_eps,
        )
    attn_out = dropout(attn_out, cfg.hidden_dropout_prob, rng, deterministic)
    x = layer_norm(x + attn_out, ap["output_layer_norm"], cfg.layer_norm_eps)
    if fusable:
        ff = fused_ffn(x, lp["intermediate"]["kernel"], lp["intermediate"]["bias"],
                       lp["output"]["kernel"], lp["output"]["bias"], act=cfg.hidden_act)
    else:
        ff = dense(activation(cfg.hidden_act)(dense(x, lp["intermediate"])), lp["output"])
    ff = dropout(ff, cfg.hidden_dropout_prob, rng, deterministic)
    return layer_norm(x + ff, lp["output_layer_norm"], cfg.layer_norm_eps)


def encoder_layer_cls(
    x: torch.Tensor,
    lp: dict,
    cfg: BertConfig,
    attn_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Final encoder layer restricted to the [CLS] query position, in plain
    torch: one query row against every key. Returns (B, 1, H)."""
    B, S, H = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    ap = lp["attention"]
    x0 = x[:, :1]
    q = dense(x0, ap["query"]).reshape(B, 1, nh, hd)
    k = dense(x, ap["key"]).reshape(B, S, nh, hd)
    v = dense(x, ap["value"]).reshape(B, S, nh, hd)
    ctx = plain_attention(q, k, v, attn_bias)
    attn_out = dense(ctx.reshape(B, 1, H), ap["output"])
    x0 = layer_norm(x0 + attn_out, ap["output_layer_norm"], cfg.layer_norm_eps)
    ff = activation(cfg.hidden_act)(dense(x0, lp["intermediate"]))
    ff = dense(ff, lp["output"])
    return layer_norm(x0 + ff, lp["output_layer_norm"], cfg.layer_norm_eps)


def encode(
    params: dict,
    cfg: BertConfig,
    hidden: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    remat=False,
    cls_only: bool = False,
) -> torch.Tensor:
    """Run the encoder layers in order.

    ``remat``: False / "none" / "unroll" (save everything), True / "full"
    (checkpoint whole layers) or "attention" (checkpoint only each
    layer's attention sub-block); see :func:`remat_mode`.

    ``cls_only``: compute the LAST layer only for the [CLS] position
    (pooled-output paths, inference only) and return (B, 1, H)."""
    mode = remat_mode(remat)
    if cls_only and not deterministic:
        raise ValueError("cls_only is an inference-path optimization")
    attn_bias = attention_bias_from_mask(attention_mask, torch.float32)
    layers: List[dict] = params["encoder"]
    body = layers[:-1] if cls_only else layers
    x = hidden
    for lp in body:
        x = encoder_layer(x, lp, cfg, attn_bias, deterministic=deterministic, rng=rng,
                          remat=mode)
    if cls_only:
        x = encoder_layer_cls(x, layers[-1], cfg, attn_bias)
    return x


def pool(params: dict, sequence_output: torch.Tensor) -> torch.Tensor:
    """BertPooler: dense + tanh on the [CLS] (first) position."""
    return torch.tanh(dense(sequence_output[:, 0], params["pooler"]))


def bert_model(
    params: dict,
    cfg: BertConfig,
    input_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat=False,
    with_pooler: bool = True,
    cls_only: bool = False,
):
    """Full BertModel forward: returns (sequence_output, pooled_output|None).

    ``cls_only`` restricts the last encoder layer to the [CLS] position;
    the returned sequence output is then (B, 1, H).  Training passes
    ``deterministic=False`` and the step's :class:`DropoutRng`; ``remat``
    goes to :func:`encode`."""
    hidden = embed(
        params, cfg, input_ids=input_ids, inputs_embeds=inputs_embeds,
        token_type_ids=token_type_ids, position_ids=position_ids,
        deterministic=deterministic, rng=rng, compute_dtype=compute_dtype,
    )
    seq = encode(params, cfg, hidden, attention_mask, deterministic=deterministic, rng=rng,
                 remat=remat, cls_only=cls_only)
    pooled = pool(params, seq) if (with_pooler and "pooler" in params) else None
    return seq, pooled
