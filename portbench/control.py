"""Readings that set a cell's limits: the program's compared numbers over
many seeds, the control's, and the planted faults'.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--requests N]
                                 [--faults] [--out file.jsonl]

One JSON line a seed and side.  For an embedding cell, the program serves
``--requests`` requests as a run's window does (as many rows are compared
as a run compares), then the control serves the same requests: the
program itself on its own int8 path (``quantize_params``), the precision
below the configurations' bfloat16; ``--faults`` also reads the
program's answers with two rows of each batch swapped and with each
request's first slot taken from the previous request.  For a pre-training cell the program
runs its set-up's checked steps, and the control is the reference itself
computed with float8 (e4m3) products, put in the program's place;
``--faults`` also plants in the program a step over half of each batch
(the mean taken over the rest), an optimizer that applies AdamW without
its bias correction and, on several cards, a step whose gradients are
not exchanged.  A state left unchanged reads 1 by the
numbers' definition and needs no run.  Every side is compared with the
float32 reference (TF32 off).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _emit(out, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def swap_rows(out, batch: int):
    """A planted fault: the first two rows of each batch of a request's
    answer swapped."""
    out = out.copy()
    for s in range(0, len(out) - 1, batch):
        out[[s, s + 1]] = out[[s + 1, s]]
    return out


def stale_slots():
    """A planted fault: the first slot of each request answered with the
    previous request's first row."""
    prev = []

    def fault(out):
        bad = out.copy()
        if prev:
            bad[0] = prev[-1][0]
        prev.append(out)
        return bad
    return fault


def embed_readings(cell, seed: int, n_requests: int, faults: bool, device, out) -> None:
    import torch

    from portbench.harness import embed, traffic as gen
    from stonkgs_tpu_torch.ops.quantization import quantize_params

    cfg, tr = cell.config, cell.traffic
    feats = embed.corpus(cfg, tr, seed)
    reqs = gen.request_rows(tr, seed, tr["corpus_rows"])
    served = [next(reqs) for _ in range(n_requests)]
    sides = {}
    for side, transform in (("program", None), ("control", quantize_params)):
        engine = embed.build_engine(cfg, tr, seed, device, transform)
        sides[side] = [engine.embed({k: v[idx] for k, v in feats.items()}) for idx in served]
        del engine
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if faults:
        sides["rows_swapped"] = [swap_rows(o, tr["batch_size"]) for o in sides["program"]]
        stale = stale_slots()
        sides["stale_slot"] = [stale(o) for o in sides["program"]]
    picks = embed.check_sample(tr, seed, feats, served)
    rows, _ = embed.checked(picks, served, sides["program"])
    want = embed.reference_embeddings(cfg, seed, feats, rows, device)
    for side, outs in sides.items():
        got = embed.checked(picks, served, outs)[1]
        _emit(out, {"workload": cell.name, "seed": seed, "side": side, "rows": len(rows),
                    **embed.compare(got, want)})


def half_batch():
    """Hooks of a planted fault: every step sees the first half of its
    batch."""
    def wrap(step):
        def half(state, batch):
            n = len(batch["input_ids"]) // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    return {"step": wrap}


def no_exchange():
    """Hooks of a planted fault: the gradients are not reduced across the
    ranks."""
    from stonkgs_tpu_torch.parallel import mesh
    mesh.ParamLayout.reduce_grads = lambda self, paths, grads: list(grads)
    return {}


def no_bias_correction():
    """Hooks of a planted fault: the optimizer applies AdamW's update
    without its bias correction (the moments themselves are right, so the
    first gradient read from them is too)."""
    import types

    import torch

    from stonkgs_tpu_torch.utils.tree import tree_leaves

    @torch.no_grad()
    def apply(self, grads, state, params, grad_norm=None):
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        lr = self.schedule(state["count"])
        g = [t.float() for t in grads]
        norm = (grad_norm(g) if grad_norm is not None
                else torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
        g = torch._foreach_mul(g, self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_add_(den, self.eps)
        torch._foreach_add_(params, torch._foreach_div(mu, den), alpha=-lr)
        state["count"] += 1

    def wrap(tx):
        tx.update_and_apply = types.MethodType(apply, tx)
        return tx
    return {"tx": wrap}


def train_readings(cell, seed: int, faults: bool, device, out) -> None:
    import torch

    from portbench.harness import train
    from portbench.reference.nn import Numerics

    cfg, tr = cell.config, cell.traffic
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)

    def program(hooks=""):
        args = (cfg, tr, cell.chips, seed, 0.0, False, device, 0.0, hooks)
        if cell.chips == 1:
            return train._rank_entry(*args)
        from stonkgs_tpu_torch.parallel.multihost import launch
        return next(r for r in launch(train._rank_entry, cell.chips, args,
                                      backend="nccl" if device == "cuda" else "gloo",
                                      timeout=900) if r["batches"] is not None)

    prog = program()
    refr = train.reference_numbers(cfg, tr, cell.chips, seed, prog["batches"], dev)
    _emit(out, {"workload": cell.name, "seed": seed, "side": "program",
                **train.compare(prog, refr), "losses": prog["losses"], "ref_losses": refr[0]})
    fp8 = train.reference_numbers(cfg, tr, cell.chips, seed, prog["batches"], dev,
                                  Numerics(fp8=True))
    losses, first, _, change = fp8
    _emit(out, {"workload": cell.name, "seed": seed, "side": "control",
                **train.compare({"losses": losses, "first": first, "change": change}, refr),
                "losses": losses})
    if faults:
        planted = [("half_batch", "portbench.control:half_batch"),
                   ("no_bias_correction", "portbench.control:no_bias_correction")]
        if cell.chips > 1:
            planted.append(("no_exchange", "portbench.control:no_exchange"))
        for name, hook in planted:
            bad = program(hook)
            _emit(out, {"workload": cell.name, "seed": seed, "side": name,
                        **train.compare(bad, refr), "losses": bad["losses"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness.spec import load_cell
    from portbench.run import set_cache_dirs

    set_cache_dirs()
    cell = load_cell(args.workload, ROOT)
    return readings(cell, args)


def readings(cell, args) -> int:
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 3
        from stonkgs_tpu_torch.ops import _build
        _build.build_all(sorted(set(sum(cell.config["sources"].values(), []))
                                | {"dense_int8"}))
    for s in args.seeds.split(","):
        t0 = time.time()
        if cell.traffic["mode"] == "embed":
            embed_readings(cell, int(s), args.requests, args.faults, torch.device(args.device),
                           args.out)
        else:
            train_readings(cell, int(s), args.faults, args.device, args.out)
        print(f"# seed {s}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
