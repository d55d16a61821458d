"""Plain PyTorch building blocks of the reference: float32, no kernels.

Written from the published model descriptions (HF ``BertModel`` and
``BigBirdModel``: post-LayerNorm, erf or tanh gelu, LayerNorm eps
1e-12), independent of the program under test.  Parameters are read from
the benchmark's weight tree (dense kernels ``(in, out)``).

``Numerics`` carries what changes between the reference and its control:
``fp8`` rounds both operands of every product to float8 e4m3 (per-tensor
absmax scale) before the float32 product, the incoming gradient of every
backward product to e5m2, and the activations kept between layers (after
each LayerNorm) to e4m3: the precision below the configurations'
bfloat16.  ``Dropout`` replays a training step's random
streams from its seed: the hidden-state masks from a device generator,
the attention masks from a counter hash keyed by two seed words drawn from
a host generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e9          # BERT's additive key bias for masked keys
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp32_only() -> None:
    """Products in true float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to a float8 format with a per-tensor absmax scale."""
    top = E4M3_MAX if dtype == torch.float8_e4m3fn else E5M2_MAX
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(F32) * scale


class _Fp8Product(torch.autograd.Function):
    """An einsum of two operands rounded to e4m3 whose backward products
    take the incoming gradient rounded to e5m2 (the float8 training
    recipe): every product of the forward and the backward in float8."""

    @staticmethod
    def forward(ctx, eq, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a, b = qa.detach().requires_grad_(), qb.detach().requires_grad_()
            ga, gb = torch.autograd.grad(torch.einsum(ctx.eq, a, b), (a, b),
                                         _fp8(g, torch.float8_e5m2))
        return None, ga, gb


@dataclasses.dataclass
class Numerics:
    fp8: bool = False

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _Fp8Product.apply("...i,ij->...j", x, w)
        return x @ w

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _Fp8Product.apply(eq, a, b)
        return torch.einsum(eq, a, b)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as it is kept between layers: float8 (e4m3, the
        gradient passing straight through) where the program keeps bf16."""
        if self.fp8:
            return x + (_fp8(x.detach(), torch.float8_e4m3fn) - x).detach()
        return x


# ---------------------------------------------------------------------------
# training randomness, replayed
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_keep(s0: int, s1: int, B: int, H: int, s_pad: int, S: int, rate: float,
              device) -> torch.Tensor:
    """(B, H, S, S) keep mask of the counter-hash dropout: a murmur3
    finalizer of ((b·H + h)·s_pad + row)·s_pad + col mixed with the two
    seed words, kept iff below (1 - rate)·2^32."""
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    r = torch.arange(S, dtype=torch.int64, device=device).view(1, 1, -1, 1)
    c = torch.arange(S, dtype=torch.int64, device=device).view(1, 1, 1, -1)
    x = (_mul32((_mul32(bh, s_pad) + r) & _M32, s_pad) + c) & _M32
    x = _mul32(x ^ s0, 0x85EBCA6B)
    x = _mul32(x ^ (x >> 16) ^ s1, 0xC2B2AE35)
    x = _mul32(x ^ (x >> 13), 0x27D4EB2F)
    x = x ^ (x >> 16)
    return x < min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def padded_rows(S: int, block_q: int = 256) -> int:
    """The hash's row pitch: S rounded up to the training attention's
    query block (128 past 1024 positions)."""
    if S > 1024:
        block_q = min(block_q, 128)
    bq = min(block_q, S)
    return -(-S // bq) * bq


class Dropout:
    """The random streams of one training micro-batch, derived from
    (run seed, step, micro-batch[, data shard]) as the training loop
    derives them."""

    def __init__(self, seed: int, step: int, device, micro: int = 0,
                 data_index: Optional[int] = None):
        entropy = [seed, step, micro] + ([] if data_index is None else [data_index])
        words = np.random.SeedSequence(entropy).generate_state(2, dtype=np.uint64)
        self.dev = torch.Generator(device=device).manual_seed(int(words[0]))
        self.host = torch.Generator().manual_seed(int(words[1]))

    def hidden(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.dev, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))

    def attention_words(self):
        w = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32, generator=self.host)
        return int(w[0]) & _M32, int(w[1]) & _M32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def dense(x, p, num: Numerics):
    y = num.mm(x, p["kernel"])
    return y + p["bias"] if "bias" in p else y


def layer_norm(x, p, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def act(name: str, x):
    if name == "gelu":
        return F.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def attention(q, k, v, bias, num: Numerics, drop: Optional[Dropout] = None,
              rate: float = 0.0):
    """(B, S, H, D) softmax attention in float32; ``bias`` adds to the
    scores; with ``drop`` the probabilities take the hash dropout."""
    B, S, H, D = q.shape
    s = num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    if drop is not None and rate > 0:
        s0, s1 = drop.attention_words()
        keep = hash_keep(s0, s1, B, H, padded_rows(S), S, rate, q.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), device=q.device))
    return num.einsum("bhqk,bkhd->bqhd", p, v)


def post_ln_layer(x, lp, cfg: dict, attend, num: Numerics, drop: Optional[Dropout]):
    """One post-LN encoder layer; ``attend(q, k, v)`` is the attention."""
    B, S, Hd = x.shape
    nh = cfg["num_attention_heads"]
    ap = lp["attention"]
    q, k, v = (dense(x, ap[n], num).reshape(B, S, nh, Hd // nh)
               for n in ("query", "key", "value"))
    a = dense(attend(q, k, v).reshape(B, S, Hd), ap["output"], num)
    rate, eps = cfg["hidden_dropout_prob"], cfg["layer_norm_eps"]
    if drop is not None:
        a = drop.hidden(a, rate)
    x = num.store(layer_norm(x + a, ap["output_layer_norm"], eps))
    f = dense(act(cfg["hidden_act"], dense(x, lp["intermediate"], num)), lp["output"], num)
    if drop is not None:
        f = drop.hidden(f, rate)
    return num.store(layer_norm(x + f, lp["output_layer_norm"], eps))
