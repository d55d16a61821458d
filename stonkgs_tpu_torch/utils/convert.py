"""Parameters of the JAX package -> parameters of the port.

The JAX package keeps a BERT's (or BigBird's) layers stacked on a leading
axis of every ``encoder`` leaf; the port keeps a list of per-layer dicts.  Every other
layout is shared (dense kernels are ``(in, out)`` in both), so the
conversion unstacks the encoder and turns numpy leaves into tensors:
floating leaves fp32, integer leaves (the int8 ``kernel_q`` of a quantized
tree) in their own dtype.
The input is a tree of numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.ops.quantization import is_quantized, quantized_to
from stonkgs_tpu_torch.utils.tree import tree_map


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, dtype=np.float32))


def bert_params_from_jax(tree: dict, cfg: BertConfig) -> dict:
    """One BERT tree: unstack ``encoder`` (leaves ``(L, ...)``) into L layers."""
    n = cfg.num_hidden_layers
    stacked = tree["encoder"]

    def layer(i):
        def take(a):
            a = np.asarray(a)
            if a.shape[0] != n:
                raise ValueError(f"encoder leaf of shape {a.shape} is not "
                                 f"stacked over {n} layers")
            return _tensor(a[i])
        return tree_map(take, stacked)

    out = {k: tree_map(_tensor, v) for k, v in tree.items() if k != "encoder"}
    out["encoder"] = [layer(i) for i in range(n)]
    return out


def bigbird_params_from_jax(tree: dict, cfg: BigBirdConfig) -> dict:
    """One BigBird tree: the same unstacking as BERT's (a BigBird layer has
    BERT's leaves, without q/k/v biases when ``cfg.use_bias`` is off)."""
    return bert_params_from_jax(tree, cfg)


def protstonkgs_params_from_jax(tree: dict, cfg: ProtSTonKGsConfig) -> dict:
    """A ProtSTonKGs tree of the JAX package -> the port's parameters.

    Unstacks the trunk and both backbones and keeps the protein
    projection, the KG table and, where present, the heads (``cls``) and
    the classifier."""
    params = {
        "trunk": bigbird_params_from_jax(tree["trunk"], cfg.trunk),
        "lm_backbone": bert_params_from_jax(tree["lm_backbone"], cfg.lm),
        "prot_backbone": bert_params_from_jax(tree["prot_backbone"], cfg.prot),
        "prot_projection": tree_map(_tensor, tree["prot_projection"]),
        "kg_backbone": _tensor(tree["kg_backbone"]),
    }
    for head in ("cls", "classifier"):
        if head in tree:
            params[head] = tree_map(_tensor, tree[head])
    return params


def params_from_jax(tree: dict, cfg: STonKGsConfig) -> dict:
    """A STonKGs tree of the JAX package -> the port's parameters.

    Keeps the trunk, the LM backbone, the KG table and, where present, the
    pre-training heads (``cls``) and the classifier."""
    params = {
        "trunk": bert_params_from_jax(tree["trunk"], cfg.bert),
        "lm_backbone": bert_params_from_jax(tree["lm_backbone"], cfg.bert),
        "kg_backbone": _tensor(tree["kg_backbone"]),
    }
    for head in ("cls", "classifier"):
        if head in tree:
            params[head] = tree_map(_tensor, tree[head])
    return params


def params_to(params: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """Move every tensor of a parameter tree, and cast its floating tensors
    to ``dtype`` when one is given.  Integer tensors keep their dtype; a
    quantized dense moves as :func:`~stonkgs_tpu_torch.ops.quantization.
    quantized_to` says (its scale and bias stay fp32)."""
    def move(t):
        if is_quantized(t):
            return quantized_to(t, device)
        return t.to(device=device,
                    dtype=dtype if dtype is not None and t.is_floating_point() else None)

    return tree_map(move, params, is_leaf=is_quantized)
