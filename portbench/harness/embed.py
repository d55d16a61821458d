"""The embedding cells: requests of feature rows through the program's
engine, one client in a closed loop.

Set-up makes the weights on the device from the seed, builds the KG
table and the engine as the program's loaders do, draws the corpus, and
warms up the one request shape the cell sends.  The window then sends a
request as soon as the previous one returned: a request is
``rows_per_request`` rows of the corpus, timed from the call of ``embed``
to its host array.  Once the window has closed and the program's state
is freed, the reference embeds a sample of the answers served (drawn
from the seed: every slot of a request at least once, the longest text
among them) and each is compared with what the window's own request
returned for it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import model, traffic as gen, work
from portbench.harness.trace import (
    Slice,
    load_op_maps,
    program_kernels,
    reduce_events,
    warm_profiler,
)
from portbench.reference import models as ref
from portbench.reference.nn import Numerics, fp32_only


def build_engine(cfg: dict, traffic: dict, seed: int, device, transform=None):
    """The program's engine on the weights of ``seed``, its KG table built
    by the program's own function; ``transform`` (such as the program's
    ``quantize_params``) maps the finished parameter tree."""
    from stonkgs_tpu_torch.api.inference import STonKGsEngine
    from stonkgs_tpu_torch.api.prot_inference import ProtSTonKGsEngine
    from stonkgs_tpu_torch.models import protstonkgs, stonkgs

    pc = model.program_config(cfg)
    params, vectors = model.make_weights(cfg, seed, device)
    vectors = vectors.cpu().numpy()
    if cfg["model"] == "stonkgs":
        params["kg_backbone"] = stonkgs.build_kg_table(params["lm_backbone"], pc.bert, vectors)
    else:
        params["kg_backbone"] = protstonkgs.build_kg_table(params["lm_backbone"], pc, vectors)
    if transform is not None:
        params = transform(params)
    if cfg["model"] == "stonkgs":
        return STonKGsEngine(cfg=pc, params=params, compute_dtype=cfg["compute_dtype"],
                             batch_size=traffic["batch_size"], device=str(device),
                             length_buckets=traffic.get("length_buckets"))
    return ProtSTonKGsEngine(cfg=pc, params=params, compute_dtype=cfg["compute_dtype"],
                             batch_size=traffic["batch_size"], device=str(device))


def corpus(cfg: dict, traffic: dict, seed: int) -> Dict[str, np.ndarray]:
    return gen.features(traffic, seed, traffic["corpus_rows"], cfg["kg_vocab_size"],
                        model.special_ids(cfg), token_types=cfg["model"] == "stonkgs")


def reference_embeddings(cfg: dict, seed: int, feats: Dict[str, np.ndarray], rows,
                         device, num: Numerics = None, block: int = 16) -> np.ndarray:
    """The reference's pooled embeddings of ``rows`` of ``feats``, float32
    with TF32 off, from the seed's weights made again."""
    fp32_only()
    num = num or Numerics()
    w, vectors = model.make_weights(cfg, seed, device)
    out = []
    with torch.no_grad():
        if cfg["model"] == "stonkgs":
            table = ref.kg_table(w["lm_backbone"], cfg["bert"], vectors,
                                 model.special_ids(cfg), num)
        else:
            table = ref.kg_table(w["lm_backbone"], cfg["lm"], vectors,
                                 model.special_ids(cfg), num)
        for i in range(0, len(rows), block):
            idx = rows[i: i + block]
            t = {k: torch.as_tensor(v[idx], device=device) for k, v in feats.items()}
            if cfg["model"] == "stonkgs":
                _, pooled = ref.stonkgs_trunk(w, cfg, table, t["input_ids"],
                                              t["attention_mask"], t["token_type_ids"], num)
            else:
                pooled = ref.protstonkgs_pooled(w, cfg, table, t["input_ids"],
                                                t["attention_mask"], num)
            out.append(pooled.float().cpu().numpy())
    del w, vectors, table
    return np.concatenate(out)


def _distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """L2 distances between the rows of ``a`` and of ``b``."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return np.sqrt(np.maximum(d2, 0.0))


def compare(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The numbers that can be compared over the checked rows: the worst
    and the median row's relative distance from the reference; the norm
    of the rows' mean error over the rows' mean norm (the error the rows
    share); and ``rows_misplaced``, the rows whose answer lies no nearer
    their own reference than another checked row's (a row swapped, a
    stale slot, another row's answer).  ``row_error_over_nearest_other``
    is the worst row's distance from its own reference over its distance
    from the nearest other, the margin of that count (misplaced at 1);
    ``row_separation_rel`` the closest two references' distance over a
    row's norm."""
    norms = np.linalg.norm(want, axis=-1)
    d = _distances(got, want)
    own = np.diag(d).copy()
    np.fill_diagonal(d, np.inf)
    other = d.min(1)
    refs = _distances(want, want)
    np.fill_diagonal(refs, np.inf)
    return {"worst_row_rel_err": float((own / norms).max()),
            "median_row_rel_err": float(np.median(own / norms)),
            "mean_error_rel": float(np.linalg.norm((got - want).mean(0)) / norms.mean()),
            "rows_misplaced": float(np.sum(~(own < other))),
            "row_error_over_nearest_other": float(np.max(own / other)),
            "row_separation_rel": float(np.min(refs.min(1) / norms))}


def check_sample(traffic: dict, seed: int, feats, served: List[np.ndarray]) -> List[tuple]:
    """The answers to check, as (request, slot) pairs of distinct corpus
    rows drawn from the seed: one at every slot of a request (each from a
    request drawn at random), then more up to ``check_rows``, and the
    answer for the longest text served."""
    rng = np.random.default_rng([seed, 0x6368])
    per = len(served[0])
    order = rng.permutation(len(served) * per)
    picks, seen, slots = [], set(), set()

    def take(k) -> bool:
        r, j = divmod(int(k), per)
        row = int(served[r][j])
        if row in seen:
            return False
        seen.add(row)
        picks.append((r, j))
        return True

    for k in order:
        if len(slots) == per:
            break
        if int(k) % per not in slots and take(k):
            slots.add(int(k) % per)
    for k in order:
        if len(picks) >= traffic["check_rows"]:
            break
        take(k)
    take(np.argmax(feats["attention_mask"][np.concatenate(served)].sum(1)))
    return picks


def checked(picks, served, outputs):
    """(corpus rows, the answers given for them) of the picked slots."""
    rows = np.asarray([served[r][j] for r, j in picks])
    return rows, np.stack([outputs[r][j] for r, j in picks])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        trace_seconds: float = 4.0, log=print) -> dict:
    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    on_card = device.type == "cuda"
    t = time.perf_counter()
    if on_card:
        from stonkgs_tpu_torch.ops import _build
        _build.build_all(cfg["sources"]["embed"])
    t_build = time.perf_counter() - t
    engine = build_engine(cfg, traffic, seed, device)
    t_engine = time.perf_counter() - t - t_build
    feats = corpus(cfg, traffic, seed)
    requests = gen.request_rows(traffic, seed, traffic["corpus_rows"])

    def take(idx):
        return {k: v[idx] for k, v in feats.items()}

    first = next(requests)
    for _ in range(2):
        engine.embed(take(first))
    if trace:
        warm_profiler(device, lambda: engine.embed(take(first)))
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()   # the set-up's objects out of the window's collections
    log(f"# set-up: build {t_build:.3f} s, weights, KG table and engine {t_engine:.3f} s, "
        f"corpus and warm-up {time.perf_counter() - t - t_build - t_engine:.3f} s")

    served, outputs, lat = [], [], []
    slicer, unprof = None, None
    t_open = time.perf_counter()
    setup_s = time.time() - t_start
    now = t_open
    while (now - t_open < seconds if slicer is None
           else slicer.elapsed() < trace_seconds):
        if trace and slicer is None and now - t_open >= seconds - trace_seconds:
            unprof = (now - t_open, len(lat))
            slicer = Slice(device)
            slicer.start()
        idx = next(requests)
        t0 = time.perf_counter()
        out = engine.embed(take(idx))
        now = time.perf_counter()
        lat.append(now - t0)
        served.append(idx)
        outputs.append(out)
    t_close = now
    events = slicer.stop() if slicer is not None else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rows = sum(len(i) for i in served)
    res = {
        "attempted": len(lat), "failed": 0, "setup_s": setup_s, "memory_peak_bytes": peak,
        "e2e": {"embed_rows_per_s": rows / (t_close - t_open),
                "embed_request_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)),
                "setup_s": setup_s},
    }
    if events is not None:
        n_slice = len(lat) - unprof[1]
        batches = -(-traffic["rows_per_request"] // traffic["batch_size"])
        red = reduce_events(events, load_op_maps(), "embed", program_kernels())
        res["ctx"] = {
            "mode": "embed", "chips": 1, "peak_flops": work.PEAKS["bf16_flops_per_s"],
            "unit": "request",
            "unprof": {"seconds": unprof[0], "units": unprof[1],
                       "rows": traffic["rows_per_request"] * unprof[1]},
            "flops_per_row": work.embed_flops_per_row(cfg),
            "slice": {**red, "units": n_slice, "wall_s": slicer.wall_s},
            "bounds_per_unit": {op: {k: v * batches for k, v in b.items()}
                                for op, b in work.op_bounds(
                                    cfg, "embed", traffic["batch_size"]).items()},
        }
    del engine
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    check_rows, got = checked(check_sample(traffic, seed, feats, served), served, outputs)
    want = reference_embeddings(cfg, seed, feats, check_rows, device)
    res["checks"] = compare(got, want)
    log(f"# checked {len(check_rows)} rows against the reference in "
        f"{time.perf_counter() - t_ref:.3f} s: {res['checks']}; window "
        f"{t_close - t_open:.3f} s, {len(lat)} requests")
    return res

