"""The rank side of ``tests/test_torch_parallel.py``: functions that run on
gloo ranks spawned by ``stonkgs_tpu_torch.parallel.multihost.launch``.

They import torch and the port only (no JAX), take configurations as
dicts and weights as numpy trees in the JAX package's layout, and return
numpy results that the test process holds against the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.parallel import multihost, tp
from stonkgs_tpu_torch.parallel.mesh import (
    _pad_to_multiple,
    all_gather,
    make_mesh,
    shard_batch,
    shard_params,
)
from stonkgs_tpu_torch.train import finetuning as tft
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.train.checkpoint import CheckpointManager
from stonkgs_tpu_torch.train.optimizer import AdamW, split_frozen
from stonkgs_tpu_torch.utils.convert import params_from_jax, protstonkgs_params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path

LR, TOTAL, CLIP = 1e-3, 10, 0.5


def stonkgs_cfg(d: dict) -> tconfig.STonKGsConfig:
    return tconfig.STonKGsConfig(**{**d, "bert": tconfig.BertConfig(**d["bert"])})


def prot_cfg(d: dict) -> tconfig.ProtSTonKGsConfig:
    return tconfig.ProtSTonKGsConfig(**{
        **d, "trunk": tconfig.BigBirdConfig(**d["trunk"]),
        "lm": tconfig.BertConfig(**d["lm"]), "prot": tconfig.BertConfig(**d["prot"])})


def _np(tree) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree_flatten_with_path(tree).items()}


class RecordingAdamW(AdamW):
    """AdamW that keeps the global norm the clip saw at every step."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.norms = []

    def update_and_apply(self, grads, state, params, grad_norm=None):
        g = [t.float() for t in grads]
        norm = (grad_norm(g) if grad_norm is not None
                else torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
        self.norms.append(float(norm))
        super().update_and_apply(grads, state, params, grad_norm=grad_norm)


def sharded_steps(variant: str, cfg_d: dict, params_np: dict, batches: list,
                  n_data=None, n_model=None, fsdp: bool = False, accum: int = 1) -> dict:
    """``make_train_step(mesh=...)`` for len(batches) steps from the JAX
    package's weights, fp32; returns the metrics, the clip's norms, the
    gathered trainable parameters and moments, and the FSDP leaves' local
    shapes.  ``n_data=None``: the unmeshed step, in this process."""
    mesh = None if n_data is None else make_mesh(n_data, n_model)
    if variant == "prot":
        cfg = prot_cfg(cfg_d)
        params = protstonkgs_params_from_jax(params_np, cfg)
        loss_fn = tprot.pretraining_loss
    else:
        cfg = stonkgs_cfg(cfg_d)
        params = params_from_jax(params_np, cfg)
        loss_fn = None
    layout = None
    if mesh is not None:
        params, layout = shard_params(params, mesh, fsdp=fsdp, fsdp_min_size=512)
    tx = RecordingAdamW(learning_rate=LR, total_steps=TOTAL, max_grad_norm=CLIP)
    state = tpre.init_train_state(params, tx, layout=layout)
    step = tpre.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=torch.float32,
                                grad_accumulation_steps=accum, mesh=mesh)
    metrics = []
    for b in batches:
        b = b if mesh is None else shard_batch(b, mesh, accum)
        state, m = step(state, tpre.to_device(b, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    train = split_frozen(state.params)[0]
    whole = (lambda t: t) if layout is None else layout.gather  # noqa: E731
    mu = tree_flatten_with_path(state.opt_state["mu"])
    split = {} if layout is None else {   # (param, first moment) local shapes
        p: (tuple(t.shape), tuple(mu[p].shape))
        for p, t in tree_flatten_with_path(train).items() if layout.kind(p) == "data"}
    return {"metrics": metrics, "norms": tx.norms, "params": _np(whole(train)),
            "mu": _np(whole(state.opt_state["mu"])), "nu": _np(whole(state.opt_state["nu"])),
            "fsdp_shapes": split}


def tp_ops(n_model: int, table: np.ndarray, ids: np.ndarray, kernel: np.ndarray,
           hidden: np.ndarray, labels: np.ndarray, true_vocab: int) -> dict:
    """``tp_gather`` and ``tp_masked_cross_entropy`` on a 1 x n_model mesh
    from full (unpadded) operands: the lookup, the loss and its gradients
    with respect to the hidden states and the whole kernel."""
    mesh = make_mesh(1, n_model)
    m = mesh.model_index
    tbl = _pad_to_multiple(torch.from_numpy(table), 0, n_model).chunk(n_model, 0)[m]
    out = tp.tp_gather(tbl, torch.from_numpy(ids), mesh)
    w = _pad_to_multiple(torch.from_numpy(kernel), 1, n_model).chunk(n_model, 1)[m].clone()
    h = torch.from_numpy(hidden).clone()
    w.requires_grad_(True)
    h.requires_grad_(True)
    loss = tp.tp_masked_cross_entropy(w, h, torch.from_numpy(labels), true_vocab, mesh)
    dw, dh = torch.autograd.grad(loss, [w, h])
    dw = all_gather(dw, mesh.model_group, 1)[:, : kernel.shape[1]]
    return {"gather": out.numpy(), "loss": float(loss.detach()), "dh": dh.numpy(),
            "dw": dw.numpy()}


def dropout_replicas(cfg_d: dict, params_np: dict, feats: dict) -> dict:
    """2 steps of ``pretrain`` on a 1 x 2 mesh with both dropouts on: this
    rank's replicated leaves and moments, to be held equal across ranks."""
    cfg = stonkgs_cfg(cfg_d)
    cfg = cfg.replace(bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=0.1,
                                               attention_probs_dropout_prob=0.1))
    mesh = make_mesh(1, 2)
    run = tpre.PretrainingConfig(learning_rate=LR, max_steps=2, micro_batch_size=4,
                                 log_steps=1, compute_dtype="float32", seed=3)
    state = tpre.pretrain(cfg, params_from_jax(params_np, cfg), feats, run, mesh=mesh)
    rep = lambda tree: {p: t.numpy() for p, t in tree_flatten_with_path(tree).items()  # noqa: E731
                        if state.layout.kind(p) == "replicated"}
    train = split_frozen(state.params)[0]
    return {"params": rep(train), "mu": rep(state.opt_state["mu"]),
            "nu": rep(state.opt_state["nu"])}


def prot_dropout_cfg(cfg_d: dict) -> tconfig.ProtSTonKGsConfig:
    """A ProtSTonKGs config with hidden dropout 0.1 in the trunk and both
    backbones (and the backbones' attention dropout 0.1)."""
    cfg = prot_cfg(cfg_d)
    return cfg.replace(
        trunk=dataclasses.replace(cfg.trunk, hidden_dropout_prob=0.1),
        lm=dataclasses.replace(cfg.lm, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1),
        prot=dataclasses.replace(cfg.prot, hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1))


def prot_dropout_pretrain(cfg_d: dict, params_np: dict, feats: dict, mesh_shape=None) -> dict:
    """2 steps of ProtSTonKGs ``pretrain`` with dropout on, fp32, on a mesh
    of ``mesh_shape`` (None: unmeshed): the logged losses and the gathered
    trainable parameters."""
    cfg = prot_dropout_cfg(cfg_d)
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    run = tpre.PretrainingConfig(learning_rate=LR, max_steps=2, micro_batch_size=4,
                                 log_steps=1, compute_dtype="float32", seed=7)
    losses = []
    state = tpre.pretrain(cfg, protstonkgs_params_from_jax(params_np, cfg), feats, run,
                          mesh=mesh, loss_fn=tprot.pretraining_loss,
                          log_fn=lambda s, m: losses.append(m["loss"]))
    train = split_frozen(state.params)[0]
    return {"losses": losses,
            "params": _np(train if state.layout is None else state.layout.gather(train))}


def resume(cfg_d: dict, params_np: dict, feats: dict, root: str) -> dict:
    """A 2 x 2 run of 4 steps with dropout on, and the same run stopped at
    step 2 and resumed: both runs' gathered parameters and losses."""
    cfg = stonkgs_cfg(cfg_d)
    cfg = cfg.replace(bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=0.1,
                                               attention_probs_dropout_prob=0.1))
    mesh = make_mesh(2, 2)
    params = params_from_jax(params_np, cfg)
    run = tpre.PretrainingConfig(learning_rate=LR, max_steps=4, micro_batch_size=4,
                                 save_steps=2, log_steps=1, compute_dtype="float32", seed=5)
    out = {}
    for name, stops in (("whole", (None,)), ("resumed", (2, None))):
        losses = []
        for stop in stops:
            state = tpre.pretrain(cfg, params, feats, dataclasses.replace(run, stop_at_step=stop),
                                  mesh=mesh, checkpoint_dir=os.path.join(root, name),
                                  log_fn=lambda s, m: losses.append((s, m["loss"])))
        out[name] = {"losses": losses, "params": _np(state.layout.gather(state.params)),
                     "mu": _np(state.layout.gather(state.opt_state["mu"])), "step": state.step}
    out["checkpoints"] = CheckpointManager(os.path.join(root, "resumed")).steps()
    return out


def multihost_cases() -> dict:
    """The cases of ``tests/test_multihost.py`` on gloo ranks."""
    assert multihost.initialize()   # already up: idempotent
    rank = dist.get_rank()
    feats = {"input_ids": np.arange(64).reshape(16, 4).astype(np.int32)}
    local = multihost.global_batch(
        {k: v[multihost.host_local_slice(16)] for k, v in feats.items()}, device="cpu")
    whole = all_gather(local["input_ids"], dist.group.WORLD, 0)
    mesh = make_mesh(2, 1)
    it = multihost.multihost_data_iterator({"input_ids": np.arange(32)[:, None]}, 8, mesh,
                                           seed=0, device="cpu")
    seen = [int(x) for _ in range(4) for x in next(it)["input_ids"].ravel()]
    return {"rank": rank, "slice": multihost.host_local_slice(16),
            "whole": whole.numpy(), "seen": seen, "backend": dist.get_backend()}


def train_classifier(cfg_d: dict, params_np: dict, head_np: dict, feats: dict) -> dict:
    """``train_classifier`` on a 2 x 1 mesh from a given classifier head."""
    cfg = stonkgs_cfg(cfg_d)
    tft.init_classifier_head = lambda gen, c, n: {k: torch.from_numpy(v.copy())
                                                  for k, v in head_np.items()}
    run = tft.FinetuneConfig(epochs=1, lr=LR, batch_size=4, compute_dtype="float32")
    state, metrics = tft.train_classifier(cfg, params_from_jax(params_np, cfg), feats, run,
                                          mesh=make_mesh(2, 1), rng_seed=3)
    return {"metrics": metrics, "params": _np(state.layout.gather(split_frozen(state.params)[0])),
            "step": state.step}


def run_pretraining_2(store: str, emb: str, output_dir: str) -> dict:
    """``run_pretraining(n_model_shards=2)`` from a memmap store: 3 steps,
    then a second call that resumes to 5."""
    from stonkgs_tpu_torch.cli import pretrain as tcli

    kw = dict(kg_embedding_path=emb, batch_size=4, save_steps=2, log_steps=1,
              output_dir=output_dir, compute_dtype="float32", device="cpu", n_model_shards=2)
    first = tcli.run_pretraining(store, max_steps=3, **kw)
    second = tcli.run_pretraining(store, max_steps=5, **kw)
    return {"steps": (first.step, second.step), "mesh": (second.layout.mesh.n_data,
                                                        second.layout.mesh.n_model),
            "params": _np(second.layout.gather(second.params))}


def world(cases: list) -> dict:
    """Run ``(name, fn, args)`` cases in order on this rank."""
    torch.manual_seed(0)
    return {name: globals()[fn](*args) for name, fn, args in cases}

