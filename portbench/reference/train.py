"""The reference STonKGs pre-training step, float32.

Loss: masked-LM over the text half's masked positions, entity-LM over the
entity half's (both through the shared transform dense -> gelu ->
LayerNorm and a bias-free decoder, the published model's quirk), plus
next-sentence prediction from the pooled output; each a mean cross
entropy over its labelled positions.  The frozen backbones take no
gradient.  The optimizer is AdamW with the HF Trainer's moments (0.9,
0.999, eps 1e-8), the gradient clipped to global norm 1, the learning
rate linear from ``lr`` to 0 over ``total_steps`` (the rate of the count
before the step, the bias correction of the count after it), and no
weight decay.

Under data parallelism the global batch is the concatenation of the
shards; shard d draws its dropout from (seed, step, 0, d), and every
mean divides by the count over the whole global batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference.models import stonkgs_trunk
from portbench.reference.nn import Dropout, Numerics, act, dense, layer_norm

FROZEN = ("lm_backbone", "kg_backbone")
IGNORE = -100


def _heads_sum(w, cfg, seq, pooled, batch, num: Numerics):
    """Summed (not averaged) cross entropies of the three objectives, and
    their label counts."""
    p = w["cls"]["predictions"]
    tl = cfg["text_len"]
    out = {}
    for name, labels, part in (("mlm", batch["masked_lm_labels"], seq[:, :tl]),
                               ("elm", batch["ent_masked_lm_labels"], seq[:, tl:])):
        sel = labels != IGNORE
        h = part[sel]
        t = act(cfg["bert"]["hidden_act"], dense(h, p["transform"]["dense"], num))
        t = layer_norm(t, p["transform"]["layer_norm"], cfg["bert"]["layer_norm_eps"])
        dec = p["text_decoder" if name == "mlm" else "entity_decoder"]["kernel"]
        logits = num.mm(t, dec)
        out[name] = (torch.nn.functional.cross_entropy(logits, labels[sel], reduction="sum"),
                     int(sel.sum()))
    nsp = dense(pooled, w["cls"]["seq_relationship"], num)
    out["nsp"] = (torch.nn.functional.cross_entropy(nsp, batch["next_sentence_labels"],
                                                    reduction="sum"),
                  int(batch["next_sentence_labels"].numel()))
    return out


def trainable(w) -> Dict[str, torch.Tensor]:
    """The trainable leaves by path."""
    out = {}

    def rec(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{path}/{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                rec(v, f"{path}/{i}")
        elif path.split("/")[0] not in FROZEN:
            out[path] = t
    rec(w, "")
    return out


def step_loss_and_grads(w, cfg, table, shards: List[dict], seed: int, step: int,
                        num: Numerics, data_parallel: bool):
    """Loss of the global batch and the gradient of every trainable leaf."""
    leaves = trainable(w)
    for t in leaves.values():
        t.requires_grad_(True)
    counts = {k: 0 for k in ("mlm", "elm", "nsp")}
    for b in shards:
        counts["mlm"] += int((b["masked_lm_labels"] != IGNORE).sum())
        counts["elm"] += int((b["ent_masked_lm_labels"] != IGNORE).sum())
        counts["nsp"] += int(b["next_sentence_labels"].numel())
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = 0.0
    for d, b in enumerate(shards):
        drop = Dropout(seed, step, table.device, 0, d if data_parallel else None)
        seq, pooled = stonkgs_trunk(w, cfg, table, b["input_ids"], b["attention_mask"],
                                    b["token_type_ids"], num, drop)
        sums = _heads_sum(w, cfg, seq, pooled, b, num)
        loss = sum(s / max(counts[k], 1) for k, (s, _) in sums.items())
        g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for (k, acc), gi in zip(grads.items(), g):
            if gi is not None:
                acc += gi
        total += float(loss.detach())
        del seq, pooled, sums, loss, g
    for t in leaves.values():
        t.requires_grad_(False)
    return total, grads


class AdamW:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float, total_steps: int,
                 max_norm: float = 1.0):
        self.lr, self.total, self.max_norm = lr, total_steps, max_norm
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Apply one step; returns the clipped gradient the moments took."""
        lr = self.lr * (1.0 - min(self.count, self.total) / self.total)
        self.count += 1
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = self.max_norm / torch.clamp(norm, min=self.max_norm)
        clipped = {k: g * factor for k, g in grads.items()}
        for k, p in leaves.items():
            g = clipped[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.mu[k] / (1 - self.b1 ** self.count)) / (
                (self.nu[k] / (1 - self.b2 ** self.count)).sqrt() + self.eps)
            p.add_(upd, alpha=-lr)
        return clipped


def run_steps(w, cfg: dict, table, batches: List[List[dict]], seed: int, lr: float,
              total_steps: int, num: Optional[Numerics] = None, data_parallel: bool = False):
    """Follow ``len(batches)`` steps from the weights ``w`` (updated in
    place).  Returns each step's loss, the per-leaf norms of the first
    step's clipped gradient, the per-leaf norms of the first step's raw
    gradient, and the per-leaf norms of the change after all steps."""
    num = num or Numerics()
    leaves = trainable(w)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = AdamW(leaves, lr, total_steps)
    losses, first, raw = [], None, None
    for step, shards in enumerate(batches):
        loss, grads = step_loss_and_grads(w, cfg, table, shards, seed, step, num,
                                          data_parallel)
        clipped = opt.step(leaves, grads)
        if first is None:
            first = {k: float(g.norm()) for k, g in clipped.items()}
            raw = {k: float(g.norm()) for k, g in grads.items()}
        losses.append(loss)
        del grads, clipped
    change = {k: float((leaves[k] - start[k]).norm()) for k in leaves}
    return losses, first, raw, change
