"""The work of a batch or a step, counted from the configuration's shapes.

Two counts:

* the model's FLOPs (``mfu.*``): every product of the forward pass (and,
  for a training step, twice that again for the backward of what trains),
  2 FLOPs a multiply-add; attention 4·S²·H a sequence a layer (scores and
  context); the frozen backbones forward only; no recomputation.
* each kernel op's calls (``roofline.*``): FLOPs and bytes of the op as it
  is defined by its inputs and outputs, never of the implementation: every
  input byte read once, every output byte written once, bf16 activations
  and weights as the op takes them, fp32 statistics.  A call's bound is
  the larger of FLOPs at the bf16 peak and bytes at the HBM peak.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())
BF16 = 2
F32 = 4


def _linear_flops(c: dict, rows: int) -> float:
    """Q, K, V, O and the two FFN products of one layer over ``rows``."""
    h, i = c["hidden_size"], c["intermediate_size"]
    return 2.0 * rows * (4 * h * h + 2 * h * i)


def _layer_flops(c: dict, batch: int, seq: int, attn_cols: int = None) -> float:
    cols = seq if attn_cols is None else attn_cols
    return _linear_flops(c, batch * seq) + 4.0 * batch * seq * cols * c["hidden_size"]


def _cls_layer_flops(c: dict, batch: int, seq: int) -> float:
    """A last layer computed at [CLS] alone: K and V over the sequence, the
    rest for one position."""
    h = c["hidden_size"]
    return (2.0 * batch * seq * 2 * h * h + _linear_flops(c, batch)
            - 2.0 * batch * 2 * h * h + 4.0 * batch * seq * h)


def _bigbird_cols(c: dict, seq: int) -> float:
    """Keys a query row attends, averaged over the sequence."""
    bs, r = c["block_size"], c["num_random_blocks"]
    nb = seq // bs
    return (2 * bs * seq + (nb - 2) * bs * (5 + r) * bs) / seq


def embed_flops_per_row(cfg: dict) -> float:
    """Model FLOPs of one embedded row."""
    if cfg["model"] == "stonkgs":
        b, tl, el = cfg["bert"], cfg["text_len"], cfg["entity_len"]
        L = b["num_hidden_layers"]
        return (L * _layer_flops(b, 1, tl) + (L - 1) * _layer_flops(b, 1, tl + el)
                + _cls_layer_flops(b, 1, tl + el) + 2.0 * b["hidden_size"] ** 2)
    t, lm, pr = cfg["trunk"], cfg["lm"], cfg["prot"]
    S, kg0, p0 = cfg["seq_len"], cfg["kg_start_idx"], cfg["prot_start_idx"]
    Lt = t["num_hidden_layers"]
    return (lm["num_hidden_layers"] * _layer_flops(lm, 3, kg0 // 3)
            + pr["num_hidden_layers"] * _layer_flops(pr, 1, S - p0)
            + 2.0 * (S - p0) * pr["hidden_size"] * t["hidden_size"]
            + (Lt - 1) * _layer_flops(t, 1, S, _bigbird_cols(t, S))
            + _cls_layer_flops(t, 1, S) + 2.0 * t["hidden_size"] ** 2)


def train_flops_per_example(cfg: dict) -> float:
    """Model FLOPs of one STonKGs pre-training example: the frozen backbone
    forward, the trunk and heads forward and backward (3x)."""
    if cfg["model"] != "stonkgs":
        raise ValueError("pre-training is counted for STonKGs")
    b, tl, el = cfg["bert"], cfg["text_len"], cfg["entity_len"]
    h, L = b["hidden_size"], b["num_hidden_layers"]
    k_text, k_ent = max(int(0.15 * tl), 1), max(int(0.15 * el), 1)
    heads = (2.0 * (k_text + k_ent) * h * h + 2.0 * k_text * h * b["vocab_size"]
             + 2.0 * k_ent * h * cfg["kg_vocab_size"] + 2.0 * h * h + 2.0 * h * 2)
    return L * _layer_flops(b, 1, tl) + 3.0 * (L * _layer_flops(b, 1, tl + el) + heads)


# ---------------------------------------------------------------------------
# kernel ops: (op, flops, bytes, calls) of a batch or a step
# ---------------------------------------------------------------------------

def ffn_ln_block(M, H, I):
    return 4.0 * M * H * I, 3 * M * H * BF16 + 2 * H * I * BF16 + (I + 5 * H) * F32


def attention_infer(B, S, H, D, bias):
    return 4.0 * B * H * S * S * D, 4 * B * S * H * D * BF16 + (B * S * F32 if bias else 0)


def bigbird_fwd(B, S, H, D, bs, r):
    mid = (S // bs - 2) * bs
    return (4.0 * B * H * mid * (5 + r) * bs * D,
            (2 * B * mid + 2 * B * S) * H * D * BF16 + B * S * F32 + B * H * mid * F32)


def attention_train_fwd(B, S, H, D, bias):
    return (4.0 * B * H * S * S * D,
            4 * B * S * H * D * BF16 + B * H * S * F32 + (B * S * F32 if bias else 0))


def attention_train_bwd(B, S, H, D, bias):
    return (10.0 * B * H * S * S * D,
            8 * B * S * H * D * BF16 + B * H * S * F32 + (B * S * F32 if bias else 0))


def ffn_train_fwd(M, H, I):
    return 4.0 * M * H * I, 2 * M * H * BF16 + 2 * H * I * BF16 + (I + H) * F32


def ffn_train_bwd(M, H, I):
    return (6.0 * M * H * I,
            3 * M * H * BF16 + 2 * M * I * BF16 + 2 * H * I * BF16 + I * F32)


def _heads(c: dict) -> Tuple[int, int]:
    return c["num_attention_heads"], c["hidden_size"] // c["num_attention_heads"]


def op_calls(cfg: dict, mode: str, batch: int) -> List[Tuple[str, float, float, int]]:
    """The kernel ops of one batch (``mode`` embed) or one step (pretrain)
    at ``batch`` rows: (op, flops, bytes, calls)."""
    out = []
    if cfg["model"] == "stonkgs":
        b, tl, el = cfg["bert"], cfg["text_len"], cfg["entity_len"]
        L, (nh, hd), H, I = (b["num_hidden_layers"], _heads(b), b["hidden_size"],
                             b["intermediate_size"])
        S = tl + el
        if mode == "embed":
            out += [("ffn_ln_block", *ffn_ln_block(batch * tl, H, I), L),
                    ("ffn_ln_block", *ffn_ln_block(batch * S, H, I), L - 1),
                    ("attention_infer", *attention_infer(batch, tl, nh, hd, False), L),
                    ("attention_infer", *attention_infer(batch, S, nh, hd, True), L - 1)]
        else:
            out += [("attention_train", *attention_train_fwd(batch, tl, nh, hd, False), L),
                    ("attention_train", *attention_train_fwd(batch, S, nh, hd, True), L),
                    ("attention_train", *attention_train_bwd(batch, S, nh, hd, True), L),
                    ("ffn_train", *ffn_train_fwd(batch * tl, H, I), L),
                    ("ffn_train", *ffn_train_fwd(batch * S, H, I), L),
                    ("ffn_train", *ffn_train_bwd(batch * S, H, I), L)]
        return out
    if mode != "embed":
        raise ValueError("ProtSTonKGs is counted for embedding")
    t, lm, pr = cfg["trunk"], cfg["lm"], cfg["prot"]
    S, kg0, p0 = cfg["seq_len"], cfg["kg_start_idx"], cfg["prot_start_idx"]
    for c, rows, seq, layers in ((lm, 3 * batch, kg0 // 3, lm["num_hidden_layers"]),
                                 (pr, batch, S - p0, pr["num_hidden_layers"])):
        nh, hd = _heads(c)
        out += [("ffn_ln_block", *ffn_ln_block(rows * seq, c["hidden_size"],
                                               c["intermediate_size"]), layers),
                ("attention_infer", *attention_infer(rows, seq, nh, hd, False), layers)]
    nh, hd = _heads(t)
    Lt = t["num_hidden_layers"] - 1
    out += [("ffn_ln_block", *ffn_ln_block(batch * S, t["hidden_size"],
                                           t["intermediate_size"]), Lt),
            ("bigbird_fwd", *bigbird_fwd(batch, S, nh, hd, t["block_size"],
                                         t["num_random_blocks"]), Lt)]
    return out


def op_bounds(cfg: dict, mode: str, batch: int) -> Dict[str, Dict[str, float]]:
    """Per op of one batch or step: the summed bound seconds of its calls
    and the summed seconds of their FLOPs and of their bytes."""
    peak, bw = PEAKS["bf16_flops_per_s"], PEAKS["hbm_bytes_per_s"]
    out: Dict[str, Dict[str, float]] = {}
    for op, flops, nbytes, calls in op_calls(cfg, mode, batch):
        d = out.setdefault(op, {"bound_s": 0.0, "flops_s": 0.0, "bytes_s": 0.0})
        d["bound_s"] += calls * max(flops / peak, nbytes / bw)
        d["flops_s"] += calls * flops / peak
        d["bytes_s"] += calls * nbytes / bw
    return out
