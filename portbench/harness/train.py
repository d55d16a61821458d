"""The pre-training cells: the program's train step over its input feed,
on one card or data-parallel over several, one process a card.

Set-up makes the weights on the device from the seed, builds the KG
table, the train state (under a mesh, each rank's layout), the step
(``make_train_step`` with ``AdamW``) and the feed (``data_iterator``
batches placed by ``_prefetch_to_device``).  It drives that same step and
feed through its first ``checked_steps`` steps, reading each loss, the
first gradient as the optimizer took it (its first moment after one
step, over 1 - b1) and the parameters' change after them, then through
``warmup_steps`` more.  The window runs the same loop on: nothing waits
for the device inside it; a CUDA event after each step gives the step
times once the window has closed.  Every rank decides to stop, and to
start the traced slice, together: a host all-reduce every
``SYNC_EVERY`` steps, so that the ranks meet at no host barrier
between.  A rank reports the forbidden modules it loaded (JAX, the JAX
package), which the parent refuses as it does its own.

After the window, with the program's state freed, the reference follows
the checked steps from the same weights and the same rows, shard by
shard with each shard's dropout, and the numbers are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import model, traffic as gen, work
from portbench.harness.guard import forbidden_modules
from portbench.harness.trace import (
    Slice,
    load_op_maps,
    program_kernels,
    reduce_events,
    warm_profiler,
)
from portbench.reference import models as ref
from portbench.reference.nn import Numerics, fp32_only
from portbench.reference.train import run_steps

B1 = 0.9
SYNC_EVERY = 8   # steps between the ranks' joint decisions to stop or to trace


def _rank_device(device: str) -> torch.device:
    if device == "cuda":
        from stonkgs_tpu_torch.parallel.multihost import local_device
        return local_device()
    return torch.device(device)


def _recording(it, keep: List, n: int):
    for b in it:
        if len(keep) < n:
            keep.append(b)
        yield b


def rank_run(cfg: dict, traffic: dict, ranks: int, seed: int, seconds: float, trace: bool,
             device: str, trace_seconds: float, hooks=None) -> dict:
    """One rank's set-up and window over ``ranks`` data ranks (the cell's
    cards); returns what the parent reports and checks (plain Python and
    numpy, so that it crosses processes)."""
    import torch.distributed as dist

    from stonkgs_tpu_torch.models import stonkgs
    from stonkgs_tpu_torch.train.optimizer import AdamW, split_frozen
    from stonkgs_tpu_torch.train.pretraining import (
        _prefetch_to_device,
        data_iterator,
        init_train_state,
        make_train_step,
        to_device,
    )
    from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path

    t_set = time.perf_counter()
    dev = _rank_device(device)
    on_card = dev.type == "cuda"
    pc = model.program_config(cfg)
    mesh = flags = None
    if ranks > 1:
        from stonkgs_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
        mesh = make_mesh(ranks, 1)
        flags = dist.new_group(backend="gloo")
    params, vectors = model.make_weights(cfg, seed, dev)
    params["kg_backbone"] = stonkgs.build_kg_table(params["lm_backbone"], pc.bert,
                                                   vectors.cpu().numpy())
    del vectors
    tx = AdamW(learning_rate=traffic["learning_rate"], total_steps=traffic["schedule_steps"])
    if hooks is not None:
        tx = hooks.get("tx", lambda t: t)(tx)
    layout = None
    if mesh is not None:
        params, layout = shard_params(params, mesh)
    state = init_train_state(params, tx, seed, layout)
    step = make_train_step(pc, tx, compute_dtype=getattr(torch, cfg["compute_dtype"]),
                           mesh=mesh)
    if hooks is not None:
        step = hooks.get("step", lambda s: s)(step)
    feats = gen.features(traffic, seed, traffic["corpus_rows"], cfg["kg_vocab_size"],
                         model.special_ids(cfg), token_types=True)
    recorded: List[Dict[str, np.ndarray]] = []
    if mesh is None:
        place = lambda b: to_device(b, dev)  # noqa: E731
    else:
        place = lambda b: to_device(shard_batch(b, mesh), dev)  # noqa: E731
    feed = _prefetch_to_device(
        _recording(data_iterator(feats, traffic["batch_size"], seed=seed), recorded,
                   traffic["checked_steps"]),
        place, 10 ** 9, traffic["prefetch_depth"])

    t_built = time.perf_counter() - t_set
    train0 = tree_flatten_with_path(split_frozen(state.params)[0])
    start = {k: v.detach().clone() for k, v in train0.items()}
    losses, first = [], None
    for i in range(traffic["checked_steps"]):
        state, m = step(state, next(feed))
        losses.append(float(m["loss"]))
        if i == 0:
            mu = tree_flatten_with_path(state.opt_state["mu"])
            first = {k: float(v.norm()) / (1.0 - B1) for k, v in mu.items()}
    now_p = tree_flatten_with_path(split_frozen(state.params)[0])
    change = {k: float((now_p[k] - start[k]).norm()) for k in start}
    del start, now_p, train0
    for _ in range(traffic["warmup_steps"]):
        state, m = step(state, next(feed))
    if trace:
        def one():
            nonlocal state
            state, _ = step(state, next(feed))
        warm_profiler(dev, one)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()   # the set-up's objects out of the window's collections
    if mesh is not None:
        dist.barrier(group=flags)

    def timer():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    marks, waits, loss_t = [timer()], [], []
    slicer, unprof = None, None
    t_open = time.perf_counter()
    window_open_epoch = time.time()
    while True:
        if mesh is None or len(waits) % SYNC_EVERY == 0:
            now = time.perf_counter()
            done = (now - t_open >= seconds) if slicer is None \
                else slicer.elapsed() >= trace_seconds
            want = torch.tensor([done, trace and slicer is None
                                 and now - t_open >= seconds - trace_seconds],
                                dtype=torch.int32)
            if mesh is not None:
                dist.all_reduce(want, op=dist.ReduceOp.MAX, group=flags)
            if want[0]:
                break
            if want[1]:
                unprof = (time.perf_counter() - t_open, len(waits))
                slicer = Slice(dev)
                slicer.start()
        t0 = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - t0)
        state, m = step(state, batch)
        loss_t.append(m["loss"])
        marks.append(timer())
    if on_card:
        torch.cuda.synchronize(dev)
    t_close = time.perf_counter()
    events = slicer.stop() if slicer is not None else None
    feed.close()
    n = len(waits)
    if on_card:
        step_s = [marks[i].elapsed_time(marks[i + 1]) * 1e-3 for i in range(n)]
    else:
        step_s = list(np.diff(marks))
    losses_w = torch.stack(loss_t).float().cpu().numpy() if loss_t else np.zeros(0)
    out = {
        "rank": getattr(mesh, "data_index", 0) if mesh is not None else 0,
        "window_open_epoch": window_open_epoch,
        "steps": n, "window_s": t_close - t_open, "step_s": step_s,
        "nonfinite": int((~np.isfinite(losses_w)).sum()),
        "waits_s": waits, "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)
        if on_card else 0,
        "losses": losses, "first": first, "change": change,
        "batches": recorded if (mesh is None or mesh.data_index == 0) else None,
        "setup_parts": {"weights_table_state_feed_s": t_built,
                        "checked_and_warmup_steps_s": t_open - t_set - t_built},
        "forbidden": forbidden_modules(),
    }
    if events is not None:
        red = reduce_events(events, load_op_maps(), "pretrain", program_kernels())
        out["slice"] = {**red, "units": n - unprof[1], "wall_s": slicer.wall_s}
        out["unprof"] = {"seconds": unprof[0], "units": unprof[1]}
        out["unprof_waits_s"] = waits[: unprof[1]]
    del state, step, feed, params
    if on_card:
        torch.cuda.empty_cache()
    return out


def _rank_entry(cfg, traffic, ranks, seed, seconds, trace, device, trace_seconds,
                hooks_name):
    """A rank process's entry.  ``hooks_name`` ("module:function", empty in
    the benchmark's runs) names a function called in the rank that plants
    a fault and may return ``{"step": wrapper, "tx": wrapper}`` for the
    step and the optimizer: the control readings and the fault tests use
    it."""
    hooks = None
    if hooks_name:
        import importlib
        mod, attr = hooks_name.rsplit(":", 1)
        hooks = getattr(importlib.import_module(mod), attr)()
    torch.set_num_threads(2)
    return rank_run(cfg, traffic, ranks, seed, seconds, trace, device, trace_seconds, hooks)


def reference_numbers(cfg: dict, traffic: dict, ranks: int, seed: int, batches, device,
                      num: Numerics = None):
    """The reference's losses and per-leaf norms over the recorded global
    batches, each split into the ``ranks`` data ranks' shards."""
    fp32_only()
    w, vectors = model.make_weights(cfg, seed, device)
    with torch.no_grad():
        table = ref.kg_table(w["lm_backbone"], cfg["bert"], vectors, model.special_ids(cfg),
                             num or Numerics())
    del vectors
    steps = []
    for b in batches:
        per = len(b["input_ids"]) // ranks
        steps.append([{k: torch.as_tensor(v[d * per: (d + 1) * per], device=device)
                       for k, v in b.items()} for d in range(ranks)])
    out = run_steps(w, cfg, table, steps, seed, traffic["learning_rate"],
                    traffic["schedule_steps"], num=num, data_parallel=ranks > 1)
    del w, table
    return out


def compare(prog: dict, refr) -> Dict[str, float]:
    """The numbers that can be compared: the relative loss gap of the worst
    checked step and of the first; by the worst leaf and by the median
    leaf, the gap between the program's and the reference's norms of the
    first clipped gradient and of the change after the checked steps, each
    over the larger of the reference's norm of that leaf and of the median
    leaf; and ``grad_shape_gap``, the median leaf's departure of its norm
    ratio (program over reference, first clipped gradient) from the
    leaves' median ratio: the clip's common factor taken out, what is left
    is how the gradient is spread over the leaves.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out."""
    losses_r, first_r, raw_r, change_r = refr
    med_raw = float(np.median(list(raw_r.values())))
    keep = [k for k, v in raw_r.items() if v >= 1e-3 * med_raw]

    def gaps(p, r):
        med = float(np.median([r[k] for k in keep]))
        return np.asarray([abs(p[k] - r[k]) / max(r[k], med) for k in keep])

    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses_r)]
    g, c = gaps(prog["first"], first_r), gaps(prog["change"], change_r)
    ratio = np.asarray([prog["first"][k] / first_r[k] for k in keep])
    return {"loss_rel_gap": float(max(loss)), "first_loss_rel_gap": float(loss[0]),
            "grad_norm_gap": float(g.max()), "grad_norm_gap_median": float(np.median(g)),
            "grad_shape_gap": float(np.median(np.abs(ratio - np.median(ratio)))),
            "change_norm_gap": float(c.max()),
            "change_norm_gap_median": float(np.median(c))}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        trace_seconds: float = 4.0, log=print, hooks_name: str = "") -> dict:
    cfg, traffic, ranks = cell.config, cell.traffic, cell.chips
    device = str(device)
    if device.startswith("cuda"):
        from stonkgs_tpu_torch.ops import _build
        _build.build_all(cfg["sources"]["pretrain"])
    args = (cfg, traffic, ranks, seed, seconds, trace, device, trace_seconds, hooks_name)
    if ranks == 1:
        results = [_rank_entry(*args)]
    else:
        from stonkgs_tpu_torch.parallel.multihost import launch
        backend = "nccl" if device.startswith("cuda") else "gloo"
        results = launch(_rank_entry, ranks, args, backend=backend, timeout=900)
    r0 = next(r for r in results if r["batches"] is not None)
    n = min(r["steps"] for r in results)
    step_s = np.asarray(r0["step_s"])
    open_epoch = max(r["window_open_epoch"] for r in results)
    setup_s = open_epoch - t_start
    window_s = max(r["window_s"] for r in results)
    examples = n * traffic["batch_size"]
    res = {
        "attempted": n, "failed": sum(r["nonfinite"] for r in results), "setup_s": setup_s,
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results),
        "forbidden": sorted(set().union(*(r["forbidden"] for r in results))),
        "e2e": {"train_examples_per_s": examples / window_s,
                "train_step_p95_ms": float(np.percentile(step_s * 1e3, 95)),
                "setup_s": setup_s},
    }
    if "slice" in r0:
        res["ctx"] = _trace_ctx(cfg, traffic, results, ranks)
    dev = torch.device("cuda", 0) if device.startswith("cuda") else torch.device(device)
    t_ref = time.perf_counter()
    refr = reference_numbers(cfg, traffic, ranks, seed, r0["batches"], dev)
    log(f"# set-up parts {r0['setup_parts']}; window {r0['window_s']:.3f} s, {n} steps; "
        f"reference {time.perf_counter() - t_ref:.3f} s")
    res["checks"] = compare(r0, refr)
    log("# reference losses " + " ".join(f"{x:.6f}" for x in refr[0]) + "; program "
        + " ".join(f"{x:.6f}" for x in r0["losses"]))
    return res


def _mean(vals):
    return float(np.mean(vals))


def _trace_ctx(cfg, traffic, results, ranks) -> dict:
    """The traced slices of every rank, averaged, as the metric readers
    take them."""
    slices = [r["slice"] for r in results]
    keys = set().union(*(s["op_s"] for s in slices))
    gkeys = set().union(*(s["group_s"] for s in slices))
    hkeys = set().union(*(s["gaps"] for s in slices))
    avg = {
        "op_s": {k: _mean([s["op_s"].get(k, 0.0) for s in slices]) for k in keys},
        "group_s": {k: _mean([s["group_s"].get(k, 0.0) for s in slices]) for k in gkeys},
        "gaps": {k: _mean([s["gaps"].get(k, 0.0) for s in slices]) for k in hkeys},
        "busy_s": _mean([s["busy_s"] for s in slices]),
        "compute_s": _mean([s["compute_s"] for s in slices]),
        "nccl_exposed_s": _mean([s["nccl_exposed_s"] for s in slices]),
        "unmapped": sorted(set().union(*(s["unmapped"] for s in slices))),
        "units": min(s["units"] for s in slices),
        "wall_s": _mean([s["wall_s"] for s in slices]),
        "kernels": _mean([s["kernels"] for s in slices]),
    }
    r0 = results[0]
    per_rank = traffic["batch_size"] // ranks
    return {
        "mode": "pretrain", "chips": ranks, "unit": "step",
        "peak_flops": work.PEAKS["bf16_flops_per_s"],
        "unprof": {"seconds": r0["unprof"]["seconds"], "units": r0["unprof"]["units"],
                   "rows": traffic["batch_size"] * r0["unprof"]["units"]},
        "flops_per_row": work.train_flops_per_example(cfg),
        "slice": avg,
        "waits_s": r0["unprof_waits_s"],
        "bounds_per_unit": work.op_bounds(cfg, "pretrain", per_rank),
    }
