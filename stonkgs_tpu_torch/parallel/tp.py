"""Tensor parallelism of the port: the KG table and the vocabulary decoders.

The port of the JAX package's ``stonkgs_tpu/parallel/tp.py``.  The KG
table is split by rows and the decoders by columns over the mesh's
``model`` axis (:func:`stonkgs_tpu_torch.parallel.mesh.param_pspec`); these
functions keep every rank on its own slice:

* :func:`tp_gather`: each rank looks up the ids in its row range and
  puts zeros elsewhere; one all-reduce over ``model`` sums them.  No rank
  ever gathers the whole table.
* :func:`tp_masked_cross_entropy`: each rank decodes its own
  ``(B, K, V/n)`` logit slice, never the whole ``(B, K, V)`` logits; the
  logsumexp comes from an all-reduce MAX (a constant shift) and an
  all-reduce SUM of the exponentials, the label's logit from a local
  lookup and an all-reduce SUM.

The gradients go through two autograd functions, Megatron's pair: the
hidden states enter the model region through :class:`_CopyToModel`
(identity forward, sum over ``model`` backward: each rank's slice of the
vocabulary contributes its part of the hidden states' gradient) and the
partial sums leave it through :class:`_ReduceFromModel` (sum forward,
identity backward: the loss is replicated over ``model``, so each rank's
cotangent is already the whole one).  ``torch.distributed.nn``'s
all-reduce would sum the cotangent again and scale the trunk's gradient
by ``n_model``.

Batch means divide by the count over the ``data`` axis as well
(:func:`stonkgs_tpu_torch.parallel.mesh.data_sum`): each data rank's loss is
its share of the global mean, and the train step sums the gradients.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from stonkgs_tpu_torch.ops.losses import IGNORE_INDEX
from stonkgs_tpu_torch.parallel.mesh import Mesh, all_reduce_, data_sum


def has_model_axis(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the table and decoders (a model axis > 1)."""
    return mesh is not None and mesh.n_model > 1


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_gather(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Row-split lookup: this rank's ``(Vp/n, H)`` rows x ``(B, L)`` ids ->
    ``(B, L, H)``, equal on every model rank (and to ``table_full[ids]``:
    one rank contributes each row, the others zeros)."""
    rows = table.shape[0]
    lo = mesh.model_index * rows
    rel = ids - lo
    in_range = (rel >= 0) & (rel < rows)
    out = table[rel.clamp(0, rows - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))
    return _ReduceFromModel.apply(out, mesh.model_group)


def tp_masked_cross_entropy(
    kernel: torch.Tensor,   # (H, Vp/n) this rank's decoder columns
    hidden: torch.Tensor,   # (B, K, H) transformed hidden states of this data rank
    labels: torch.Tensor,   # (B, K) int labels, IGNORE_INDEX to skip
    true_vocab: int,        # the unpadded vocabulary
    mesh: Mesh,
) -> torch.Tensor:
    """Vocab-parallel decode + mean masked cross entropy (fp32).

    The value of :func:`stonkgs_tpu_torch.ops.losses.masked_cross_entropy`
    over ``hidden @ kernel_full[:, :true_vocab]``, the mean taken over the
    global batch; no rank holds more than its ``(B, K, V/n)`` slice."""
    vloc = kernel.shape[1]
    lo = mesh.model_index * vloc
    group = mesh.model_group
    x = _CopyToModel.apply(hidden, group)
    logits = (x @ kernel.to(x.dtype)).float()
    # padded decoder columns must not enter the logsumexp
    col_ok = torch.arange(vloc, device=logits.device) + lo < true_vocab
    logits = logits.masked_fill(~col_ok, float("-inf"))
    with torch.no_grad():   # the shift is a constant: the value is shift-invariant
        gmax = all_reduce_(logits.amax(dim=-1).contiguous(), group, dist.ReduceOp.MAX)
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    lse = gmax + torch.log(_ReduceFromModel.apply(sumexp, group))
    valid = labels != IGNORE_INDEX
    rel = torch.where(valid, labels, 0).to(torch.int64) - lo
    in_range = (rel >= 0) & (rel < vloc)
    tgt = torch.gather(logits, -1, rel.clamp(0, vloc - 1)[..., None])[..., 0]
    tgt = _ReduceFromModel.apply(torch.where(in_range, tgt, 0.0), group)
    w = valid.float()
    total = ((lse - tgt) * w).sum()
    return total / data_sum(w.sum(), mesh).clamp_min(1.0)


def tp_decode_cross_entropy(head_params: dict, hidden: torch.Tensor, labels: torch.Tensor,
                            segment: str, true_vocab: int, mesh: Mesh) -> torch.Tensor:
    """One segment's decode + loss through :func:`tp_masked_cross_entropy`;
    ``hidden`` is already transformed (``heads.elm_transform``) and the
    decoder is bias-free (the reference's quirk)."""
    return tp_masked_cross_entropy(head_params[f"{segment}_decoder"]["kernel"],
                                   hidden, labels, true_vocab, mesh)
