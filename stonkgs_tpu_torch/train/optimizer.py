"""The pre-training optimizer of the port, with HF Trainer semantics.

The port of the JAX package's ``stonkgs_tpu/train/optimizer.py``: AdamW
(b1 0.9, b2 0.999, eps 1e-8), weight decay on leaves with ndim >= 2 only,
a linear schedule from ``lr`` to 0 after an optional warmup, and
global-norm clipping at ``max_grad_norm`` (1.0, as pre-training uses;
``None`` turns it off, as the JAX package's ``make_optimizer`` allows).
The frozen backbones are split off structurally (:func:`split_frozen`):
they never get gradients or optimizer state.

:class:`AdamW` is the math of the JAX package's
``FusedClippedAdamW.update_and_apply`` (``optimizer.py:177-203``): the clip
factor ``max_norm / max(norm, max_norm)`` folded into the moment update.
It updates the parameters and moments in place (the JAX function returns
new arrays), which keeps one copy of each on the card.

Under a mesh the leaves are this rank's slices: the moments and the decay
work on them as they are, and the clip takes the norm of the global
gradient from the ``grad_norm`` the train step passes
(:meth:`stonkgs_tpu_torch.parallel.mesh.ParamLayout.grad_norm`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

FROZEN_PREFIXES = ("lm_backbone", "kg_backbone", "prot_backbone")


def linear_schedule(lr: float, total_steps: int,
                    warmup_steps: int = 0) -> Callable[[int], float]:
    """HF 'linear' scheduler: warmup 0 -> lr, then linear decay lr -> 0
    (optax's ``linear_schedule`` and ``join_schedules``)."""
    def linear(init, end, steps, count):
        return (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end

    def schedule(count: int) -> float:
        if warmup_steps > 0:
            if count < warmup_steps:
                return linear(0.0, lr, warmup_steps, count)
            return linear(lr, 0.0, max(total_steps - warmup_steps, 1),
                          count - warmup_steps)
        return linear(lr, 0.0, max(total_steps, 1), count)

    return schedule


def trainable_mask(params, frozen_prefixes: Sequence[str] = FROZEN_PREFIXES):
    """The tree of ``params`` with each leaf labelled "train" or "frozen"
    by its top-level key (the JAX package's ``trainable_mask``)."""
    return {k: tree_map(lambda _: "frozen" if k in frozen_prefixes else "train", v)
            for k, v in params.items()}


def make_optimizer(params=None, *, learning_rate: float = 1e-4, total_steps: int = 10_000,
                   warmup_steps: int = 0, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: Optional[float] = 1.0,
                   frozen_prefixes: Sequence[str] = FROZEN_PREFIXES,
                   fused: bool = False) -> "AdamW":
    """The JAX package's ``make_optimizer``: an :class:`AdamW` with these
    settings.  ``params`` and ``frozen_prefixes`` are accepted for its
    signature (the train step splits the frozen subtree off itself), and
    ``fused`` too: the port's update is always one pass of ``foreach``
    kernels over the leaves."""
    del params, frozen_prefixes, fused
    tx = AdamW(learning_rate=learning_rate, total_steps=total_steps,
               warmup_steps=warmup_steps, weight_decay=weight_decay,
               max_grad_norm=max_grad_norm)
    tx.b1, tx.b2, tx.eps = b1, b2, eps
    return tx


def split_frozen(params: dict, frozen_prefixes: Sequence[str] = FROZEN_PREFIXES):
    """Split a parameter dict into (trainable, frozen) top-level subtrees."""
    train = {k: v for k, v in params.items() if k not in frozen_prefixes}
    frozen = {k: v for k, v in params.items() if k in frozen_prefixes}
    return train, frozen


def merge_frozen(train: dict, frozen: dict) -> dict:
    """Inverse of :func:`split_frozen`."""
    return {**train, **frozen}


class AdamW:
    """Clipped AdamW over the trainable subtree, updating in place, with
    the HF Trainer's moments and epsilon; ``max_grad_norm=None`` skips
    the clip."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, *, learning_rate: float = 1e-4, total_steps: int = 10_000,
                 warmup_steps: int = 0, weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = 1.0):
        self.schedule = linear_schedule(learning_rate, total_steps, warmup_steps)
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, train_params) -> dict:
        """Zero moments in each leaf's dtype, and the step count."""
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, train_params),
                "nu": tree_map(zeros, train_params)}

    @torch.no_grad()
    def update_and_apply(self, grads: list, state: dict, params: list,
                         grad_norm: Optional[Callable[[list], torch.Tensor]] = None) -> None:
        """One step: clip, moments, bias correction, decay, apply.

        ``grads`` and ``params`` are leaf lists in the order of
        ``tree_leaves`` of the tree ``state`` was made from; params and
        ``state`` change in place.  The learning rate is the schedule's at
        the step count before this step, the bias correction uses the
        count after it (as optax).  ``grad_norm(grads)`` gives the clip's
        global norm where the leaves are slices of a sharded tree; by
        default it is the norm over ``grads``."""
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        g = [t.float() for t in grads]
        if self.max_grad_norm is not None:
            norm = (grad_norm(g) if grad_norm is not None
                    else torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
            g = torch._foreach_mul(
                g, self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        den = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            decayed = [(u, p) for u, p in zip(upd, params) if p.dim() >= 2]
            if decayed:
                torch._foreach_add_([u for u, _ in decayed], [p for _, p in decayed],
                                    alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        state["count"] = count
