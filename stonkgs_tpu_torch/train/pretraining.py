"""Pre-training engine of the port: the train step and the training loop.

The port of the JAX package's ``stonkgs_tpu/train/pretraining.py`` for one
device: ``make_train_step`` differentiates a pre-training loss (by default
:func:`stonkgs_tpu_torch.models.stonkgs.pretraining_loss`; ProtSTonKGs
passes :func:`stonkgs_tpu_torch.models.protstonkgs.pretraining_loss`) with
respect to the trainable subtree (trunk, projection and heads; the frozen
backbones run under ``torch.no_grad()``), accumulates gradients over
micro-batches in fp32, and applies :class:`stonkgs_tpu_torch.train.optimizer.AdamW`.  ``pretrain``
drives it over a shuffled feature set (arrays or the memmaps of a
:class:`~stonkgs_tpu_torch.data.memmap_dataset.MemmapFeatureStore`) with a
prefetching input thread, a deferred metric fetch, a non-finite-loss
watchdog and checkpoints (:mod:`stonkgs_tpu_torch.train.checkpoint`):
saved every ``save_steps`` with rotation, and resumed from the newest.

The parameters' device is the device of the run: the entry points run on
the card when the parameters are there, as ``chip_smoke.py`` puts them.

Randomness is explicit: a step's generators are derived from the run's
seed and the step number (:func:`step_rng`), so any step can be replayed.

Under a mesh (:mod:`stonkgs_tpu_torch.parallel.mesh`, the JAX package's
``mesh`` argument) every rank runs this loop on its share: it keeps its
slices of the parameters and moments (the KG table and decoders split
over ``model``, with ``fsdp`` the large replicated leaves over ``data``),
feeds its own rows of every global batch, and the step sums the gradients
over the data axis with explicit collectives; the metrics are the global
batch's.  A 1 x 1 mesh runs the unmeshed arithmetic bit for bit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from stonkgs_tpu_torch.config import ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.models.bert import DropoutRng, remat_mode
from stonkgs_tpu_torch.parallel.mesh import (
    Mesh,
    ParamLayout,
    all_reduce_,
    shard_batch,
    shard_params,
)
from stonkgs_tpu_torch.train.checkpoint import CheckpointManager
from stonkgs_tpu_torch.train.optimizer import AdamW, merge_frozen, split_frozen
from stonkgs_tpu_torch.utils.batching import host_to_device
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """Train-step carry: step counter, params, optimizer state, run seed,
    and under a mesh the layout of the rank's slices (None otherwise)."""
    step: int
    params: dict
    opt_state: dict
    seed: int
    layout: Optional[ParamLayout] = None

    def tree(self) -> dict:
        """The state as a dict (the JAX package's ``TrainState.tree``, with
        the run's seed where it keeps a key)."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.opt_state, "seed": self.seed}


def init_train_state(params: dict, tx: AdamW, seed: int = 0,
                     layout: Optional[ParamLayout] = None) -> TrainState:
    """The train state; optimizer state covers the TRAINABLE subtree only
    (under a mesh, the rank's slices of it, as ``layout`` records)."""
    return TrainState(step=0, params=params, opt_state=tx.init(split_frozen(params)[0]),
                      seed=seed, layout=layout)


def resolve_train_impl(remat="auto", attention_impl="auto", mesh=None):
    """The training configuration: ``(remat, "flash")``, remat False or
    the mode asked for ("full" or "attention"; "none" and "unroll" are
    False), attention and the FFN always on the training kernels.

    "auto" (and None or True, as in the JAX package) resolves to no remat,
    the JAX package's choice where its flash kernel trains
    (``stonkgs_tpu/train/pretraining.py:96-104``): the port always trains
    through its flash attention and FFN kernels, whose backward kernels
    recompute the S^2 and FFN intermediates themselves, so a layer keeps
    only its (B, S, H)-sized activations: the full-width step at B=32
    peaked 11.4 GB above its start on an H100 80GB (``chip_smoke.py``
    phase 23, one rank).  Remat would only add recompute.  ``attention_impl`` "xla", "flash"
    and "auto" all take the kernels.  A ``mesh`` changes nothing here:
    every rank runs the same kernels on its rows (the JAX package wraps
    them in ``shard_map``)."""
    if remat in ("auto", None, True):
        remat = False
    mode = remat_mode(remat)
    if attention_impl not in (None, "auto", "flash", "xla"):
        raise ValueError(f"attention_impl={attention_impl!r}: 'auto', 'flash' or 'xla' "
                         "(all train through the port's flash attention kernels)")
    return (False if mode == "none" else mode), "flash"


def step_rng(seed: int, step: int, device, micro: int = 0,
             data_index: Optional[int] = None) -> DropoutRng:
    """The generators of micro-batch ``micro`` of step ``step``: a device
    generator for hidden-state dropout and a CPU one for the attention
    seeds, both seeded from (seed, step, micro), and from the data shard's
    index where one is given (a mesh with a data axis: the shards draw
    different masks, the ranks of one shard the same)."""
    entropy = [seed, step, micro] + ([] if data_index is None else [data_index])
    words = np.random.SeedSequence(entropy).generate_state(2, dtype=np.uint64)
    return DropoutRng(
        device=torch.Generator(device=device).manual_seed(int(words[0])),
        host=torch.Generator().manual_seed(int(words[1])))


def make_train_step(
    cfg: Union[STonKGsConfig, ProtSTonKGsConfig],
    tx: AdamW,
    *,
    loss_fn: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    grad_accumulation_steps: int = 1,
    remat=False,
    mesh: Optional[Mesh] = None,
):
    """The train step: ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, cfg, batch, deterministic=False, rng=...,
    compute_dtype=...) -> (loss, metrics)`` defaults to the STonKGs
    MLM + ELM + NSP loss; a ProtSTonKGs run passes
    ``protstonkgs.pretraining_loss`` (with its training plan bound by
    ``functools.partial(..., rand_attn=plan)`` where it keeps one).
    ``remat`` (a mode of :func:`~stonkgs_tpu_torch.models.bert.remat_mode`
    other than none) reaches the loss as its ``remat`` keyword, whichever
    loss it is: every loss of the port passes it to its trunk.
    ``batch`` holds ``grad_accumulation_steps * micro_batch`` rows on the
    parameters' device; gradients of the micro-batches are summed in fp32
    and averaged, as are the metrics (0-dim tensors on the device).  The
    state is updated in place and returned.

    Under a ``mesh`` (the state made by :func:`pretrain` or
    :func:`~stonkgs_tpu_torch.parallel.mesh.shard_params`, so it carries its
    layout) ``batch`` holds this rank's rows
    (:func:`~stonkgs_tpu_torch.parallel.mesh.shard_batch`), the loss gets
    ``tp_mesh=mesh``, and the step all-gathers the data-split (FSDP) leaves
    before the forward and reduces the gradients after the backward
    (:meth:`~stonkgs_tpu_torch.parallel.mesh.ParamLayout.reduce_grads`);
    the clip takes the global norm and the metrics are summed over the
    data axis (each rank's loss is its share of the global mean)."""
    mode = remat_mode(remat)
    n = grad_accumulation_steps
    if loss_fn is None:
        loss_fn = stonkgs.pretraining_loss
    extra = {} if mode == "none" else {"remat": mode}
    if mesh is not None:
        mesh.require_groups()
        extra["tp_mesh"] = mesh
    data_index = mesh.data_index if mesh is not None and mesh.n_data > 1 else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        layout = state.layout
        if (mesh is None) != (layout is None) or (layout is not None and layout.mesh is not mesh):
            raise ValueError("the train state's layout does not belong to the step's mesh")
        train_p, frozen_p = split_frozen(state.params)
        leaves = tree_leaves(train_p)
        device = leaves[0].device
        if layout is not None and layout.has_fsdp:
            # the step's view: data-split leaves whole, for this step only
            train_v, frozen_v = layout.gather_fsdp(train_p), layout.gather_fsdp(frozen_p)
        else:
            train_v, frozen_v = train_p, frozen_p
        view = tree_leaves(train_v)
        micro = [batch] if n == 1 else [
            {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            for i in range(n)]
        grads = metrics = None
        try:
            for t in view:
                t.requires_grad_(True)
            for i, mb in enumerate(micro):
                loss, m = loss_fn(
                    merge_frozen(train_v, frozen_v), cfg, mb, deterministic=False,
                    rng=step_rng(state.seed, state.step, device, i, data_index),
                    compute_dtype=compute_dtype, **extra)
                g = torch.autograd.grad(loss, view, allow_unused=True)
                # leaves outside the loss (the ELM decoder biases, the
                # trunk's word embeddings) get zeros
                g = [torch.zeros_like(p, dtype=torch.float32) if gi is None else gi.float()
                     for p, gi in zip(view, g)]
                m = {k: v.detach().float() for k, v in m.items()}
                if grads is None:
                    grads, metrics = g, m
                else:
                    torch._foreach_add_(grads, g)
                    metrics = {k: metrics[k] + m[k] for k in m}
        finally:
            for t in view:
                t.requires_grad_(False)
        if n > 1:
            torch._foreach_mul_(grads, 1.0 / n)
            metrics = {k: v / n for k, v in metrics.items()}
        clip = {}   # a split tree's global norm; the unmeshed call is unchanged
        if layout is not None:
            paths = list(tree_flatten_with_path(train_p))
            grads = layout.reduce_grads(paths, grads)
            norm = layout.grad_norm(paths)
            if norm is not None:
                clip["grad_norm"] = norm
            names = sorted(metrics)
            total = all_reduce_(torch.stack([metrics[k] for k in names]), mesh.data_group)
            metrics = dict(zip(names, total.unbind()))
        tx.update_and_apply(grads, state.opt_state, leaves, **clip)
        state.step += 1
        return state, metrics

    return train_step


@dataclasses.dataclass
class PretrainingConfig:
    """Run configuration: the fields of the JAX package's
    ``PretrainingConfig`` that the port runs, with its defaults (the
    reference CLI's).  ``fsdp`` and ``fsdp_min_size`` act under a mesh;
    ``remat`` and ``attention_impl`` go through :func:`resolve_train_impl`."""

    learning_rate: float = 1e-4
    max_steps: int = 200
    warmup_steps: int = 0
    weight_decay: float = 0.0
    micro_batch_size: int = 8
    grad_accumulation_steps: int = 1
    save_steps: int = 5000
    save_total_limit: int = 5
    log_steps: int = 100
    seed: int = 0
    compute_dtype: str = "bfloat16"
    remat: bool = False
    attention_impl: str = "auto"
    # split params, gradients and both moments over the data axis
    # (ZeRO-3 storage; the reference's DeepSpeed config stops at stage 2)
    fsdp: bool = False
    # smallest leaf (elements) fsdp splits; None = mesh.FSDP_MIN_SIZE
    fsdp_min_size: Optional[int] = None
    # stop (cleanly, with a checkpoint) after this step while the LR
    # schedule stays pinned to max_steps: a resumed run continues to
    # max_steps on the trajectory of an uninterrupted one
    stop_at_step: Optional[int] = None

    @property
    def batch_size(self) -> int:
        return self.micro_batch_size * self.grad_accumulation_steps


class _EndOfStream(Exception):
    """A finite iterator ran out before the run's last step."""


def _prefetch_to_device(it, place, n_steps: int, depth: int = 3):
    """Yield ``n_steps`` placed batches, prepared on a background thread so
    the host gather and the copy to the device overlap the running step.

    The producer checks a stop event at every (timed) queue put, so a
    consumer that stops early (an exception, the watchdog, ``close()``)
    releases the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def work():
        try:
            for _ in range(n_steps):
                try:
                    item = place(next(it))
                except StopIteration:
                    raise _EndOfStream("data iterator exhausted early")
                put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            put(e)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    try:
        for _ in range(n_steps):
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def data_iterator(
    features: Dict[str, np.ndarray],
    batch_size: int,
    *,
    seed: int = 0,
    skip_steps: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffling epoch iterator over preprocessed feature arrays (the JAX
    package's, batch for batch).  ``skip_steps`` fast-forwards without
    materialising the skipped batches."""
    n = len(features["input_ids"])
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} examples < batch_size {batch_size}: the "
            f"epoch loop would never yield")
    rng = np.random.default_rng(seed)
    steps_per_epoch = max((n - batch_size) // batch_size + 1, 0)
    while skip_steps >= steps_per_epoch > 0:
        rng.permutation(n)
        skip_steps -= steps_per_epoch
    while True:
        perm = rng.permutation(n)
        start = skip_steps * batch_size
        skip_steps = 0
        for i in range(start, n - batch_size + 1, batch_size):
            idx = perm[i: i + batch_size]
            yield {k: v[idx] for k, v in features.items()}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (integers as int64), copied
    from pinned host memory without blocking when the device is a card."""
    return {k: host_to_device(v, device, None if np.asarray(v).dtype.kind == "f" else torch.int64)
            for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pretrain(
    cfg: Union[STonKGsConfig, ProtSTonKGsConfig],
    params: dict,
    features: Dict[str, np.ndarray],
    run_cfg: PretrainingConfig,
    *,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    loss_fn: Optional[Callable] = None,
) -> TrainState:
    """Run the pre-training loop on the parameters' device; with a
    ``checkpoint_dir``, resume from its newest checkpoint and save there.

    ``loss_fn`` defaults to the STonKGs MLM + ELM + NSP loss; pass
    ``protstonkgs.pretraining_loss`` for the tri-modality variant (see
    :func:`make_train_step`).

    The caller's trainable tensors are copied first (the step updates in
    place); the frozen backbones are shared and never written.  Metrics of
    a log step are fetched one log interval later, so the copy to the host
    overlaps the running steps; the watchdog raises ``FloatingPointError``
    after three non-finite losses in a row, up to one interval late, and
    always before a save could rotate out the last good checkpoint.
    ``log_fn(step, metrics)`` gets floats, ``elapsed_sec`` and, after the
    first step of this run, ``examples_per_sec`` over this run's steps.

    Checkpoints are saved every ``save_steps``, at ``max_steps`` and at
    ``stop_at_step``, keeping ``save_total_limit``; the mid-run saves write
    their files on a background thread, the last one blocks.  A resumed
    run fast-forwards the data to its step and draws every step's dropout
    from (seed, step), so it replays the uninterrupted run.

    With a ``mesh`` (every rank of the process group calls ``pretrain``
    with the same arguments and the full ``params``) each rank keeps its
    slices (``run_cfg.fsdp`` splits the large replicated leaves too),
    feeds its own rows of every batch of the shared data order, and logs
    the global batch's metrics; the returned state holds the rank's
    slices and their layout (``ParamLayout.gather`` makes them whole).
    Checkpoints are gathered: the main rank writes the single-device
    format, and every rank restores its slices from it, so a run can
    resume on another mesh or on one card."""
    remat, _ = resolve_train_impl(run_cfg.remat, run_cfg.attention_impl, mesh)
    train, frozen = split_frozen(params)
    params = merge_frozen(tree_map(lambda t: t.detach().clone(), train), frozen)
    layout = None
    if mesh is not None:
        mesh.require_groups()
        params, layout = shard_params(params, mesh, fsdp=run_cfg.fsdp,
                                      fsdp_min_size=run_cfg.fsdp_min_size)
    device = tree_leaves(train)[0].device
    tx = AdamW(learning_rate=run_cfg.learning_rate, total_steps=run_cfg.max_steps,
               warmup_steps=run_cfg.warmup_steps, weight_decay=run_cfg.weight_decay)
    state = init_train_state(params, tx, run_cfg.seed, layout)
    ckpt = None
    start_step = 0
    if checkpoint_dir is not None:
        ckpt = CheckpointManager(checkpoint_dir, run_cfg.save_total_limit)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, start_step = restored, restored.step
    step_fn = make_train_step(
        cfg, tx, loss_fn=loss_fn, compute_dtype=getattr(torch, run_cfg.compute_dtype),
        grad_accumulation_steps=run_cfg.grad_accumulation_steps, remat=remat, mesh=mesh)
    if mesh is None:
        place = lambda b: to_device(b, device)  # noqa: E731
    else:
        # every rank draws the same global order and keeps its own rows
        place = lambda b: to_device(  # noqa: E731
            shard_batch(b, mesh, run_cfg.grad_accumulation_steps), device)
    batches = _prefetch_to_device(
        data_iterator(features, run_cfg.batch_size, seed=run_cfg.seed,
                      skip_steps=start_step),
        place, max(run_cfg.max_steps - start_step, 0))

    t0 = time.perf_counter()
    steady_t0 = None  # set after this run's first step, which throughput excludes
    nan_streak = 0
    pending = None    # (1-based step, metric names, host values, event)

    def start_fetch(step_num, metrics):
        names = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in names])
        event = None
        if vals.is_cuda:
            vals = vals.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return step_num, names, vals, event

    def fetch_and_log(step_num, names, vals, event):
        nonlocal nan_streak
        if event is not None:
            event.synchronize()
        m = dict(zip(names, vals.tolist()))
        if not np.isfinite(m["loss"]):
            nan_streak += 1
            if nan_streak >= 3:
                raise FloatingPointError(
                    f"non-finite loss for {nan_streak} consecutive checks at "
                    f"step {step_num}; the last checkpoint is in {checkpoint_dir}")
        else:
            nan_streak = 0
        if log_fn:
            now = time.perf_counter()
            m["elapsed_sec"] = now - t0
            steady_steps = step_num - 1 - start_step
            if steady_steps > 0 and steady_t0 is not None:
                m["examples_per_sec"] = run_cfg.batch_size * steady_steps / (now - steady_t0)
            log_fn(step_num, m)

    try:
        for step in range(start_step, run_cfg.max_steps):
            state, metrics = step_fn(state, next(batches))
            if steady_t0 is None:
                _sync(device)
                steady_t0 = time.perf_counter()
            stopping = run_cfg.stop_at_step is not None and step + 1 >= run_cfg.stop_at_step
            final = step + 1 == run_cfg.max_steps or stopping
            if (step + 1) % run_cfg.log_steps == 0 or final:
                started = start_fetch(step + 1, metrics)
                if pending is not None:
                    fetch_and_log(*pending)
                pending = started
            if ckpt is not None and ((step + 1) % run_cfg.save_steps == 0 or final):
                # the watchdog sees every logged loss before a save rotates
                if pending is not None:
                    fetch_and_log(*pending)
                    pending = None
                ckpt.save(step + 1, state, blocking=final)
            if stopping:
                break
        if pending is not None:
            fetch_and_log(*pending)
        if ckpt is not None:
            ckpt.wait()
    finally:
        batches.close()
    return state
