"""Where the time of one pre-training step (or serving batch) goes, on one
CUDA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 profile_train_step.py [--model stonkgs|stonkgs-finetune|protstonkgs]
                                  [--serve [--int8]] [--heads N]
                                  [--out profile_train_step.json]

Builds the port's kernels and makes the full-width model of
``chip_smoke.py`` with random seeded weights: STonKGs (BERT-base backbone
and trunk, 256 + 256, KG vocabulary 100,000; B=32), the same model
fine-tuned (``classification_loss``, two labels, B=8: a step of the
fine-tuning battery) or ProtSTonKGs (BigBird trunk, BioBERT, ProtBERT
30 x 1024, 4096 tokens, KG vocabulary 20,000; B=2 with the training
plan); ``--heads N`` splits the trunk's width into N attention heads
(STonKGs: every BERT stack, as ``chip_smoke.py``'s head-split paths;
ProtSTonKGs: the BigBird trunk) in place of the published 12.  It runs
two warm-up steps of
``make_train_step`` in bf16 with fp32 parameters, then traces three steps
with ``torch.profiler`` (each step synchronised through its loss).  With
``--serve`` it traces three embed batches in bf16 instead
(``STonKGsEngine`` at B=128, ``ProtSTonKGsEngine`` at B=8), and with
``--int8`` as well the same engine on ``quantize_params`` output (int8
serving: every dense but the pooler through ``dense_int8``).  It prints
the device time by kernel, the device time by group (the port's kernels,
cuBLAS products, everything else), and the device's busy share of the
traced wall time (the sum of kernel times over the wall time: one stream,
so kernels do not overlap), the operators with the most host time, and
writes the groups to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from stonkgs_tpu_torch import ProtSTonKGsEngine, STonKGsEngine
from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import protstonkgs, stonkgs
from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.ops.quantization import quantize_params
from stonkgs_tpu_torch.train import pretraining
from stonkgs_tpu_torch.train.optimizer import AdamW
from stonkgs_tpu_torch.utils.convert import params_to

# kernel-name prefixes of the port's own CUDA kernels (csrc/*.cu, *.cuh);
# a template that serves two entry points is told apart by its first bool
# template argument (kTrain, kLN; the FFN GEMM's kBKMajor: W K-major is
# the training backward's dx, W MN-major the training forward or, in a
# serving trace, the serving block)
PORT_KERNELS = {
    "attn_fwd_kernel": ("flash_attention_infer", "flash_attention_train_fwd"),
    "attn_fwd_sm90_kernel": ("flash_attention_infer", "flash_attention_train_fwd"),
    "attn_bwd_delta_kernel": "flash_attention_train_bwd",
    "attn_bwd_dq_kernel": "flash_attention_train_bwd",
    "attn_bwd_dkdv_kernel": "flash_attention_train_bwd",
    "attn_bwd_dq_sm90_kernel": "flash_attention_train_bwd",
    "attn_bwd_dkdv_sm90_kernel": "flash_attention_train_bwd",
    "attn_fwd_wide_sm90_kernel": ("flash_attention_infer", "flash_attention_train_fwd"),
    "attn_fwd_rows_kernel": ("flash_attention_infer", "flash_attention_train_fwd"),
    "attn_bwd_ds_wide_sm90_kernel": "flash_attention_train_bwd",
    "attn_bwd_gemm_wide_sm90_kernel": "flash_attention_train_bwd",
    "attn_bwd_dq_rows_kernel": "flash_attention_train_bwd",
    "attn_bwd_dkdv_rows_kernel": "flash_attention_train_bwd",
    "ffn_fwd_kernel": ("ffn_train_fwd", "ffn_ln_block"),
    "gemm_sm90_kernel": ("ffn_train_fwd", "ffn_train_bwd"),
    "add_layer_norm_kernel": "ffn_ln_block",
    "ffn_bwd_kernel": "ffn_train_bwd",
    "ffn_bwd_dual_sm90_kernel": "ffn_train_bwd",
    "mid_fwd_kernel": "bigbird_mid_fwd",
    "mid_bwd_kernel": "bigbird_mid_bwd",
    "bigbird_fwd_sm90_kernel": "bigbird_mid_fwd",
    "bigbird_fwd_wide_sm90_kernel": "bigbird_mid_fwd",
    "bigbird_bwd_sm90_kernel": "bigbird_mid_bwd",
    "quantize_rows_kernel": "dense_int8",
    "gemm_kmajor_sm90_kernel": "dense_int8",
}
STEPS = 3  # traced steps
# cuBLAS kernels on Hopper are named nvjet_*, sm90_xmma_gemm_* or *gemm*
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")


def group_of(name: str, serve: bool = False) -> str:
    """The group a device kernel's time is booked to (``serve``: a serving
    trace)."""
    # the kernel's own name: before its template and parameter lists (a
    # parameter's type may hold "::" too)
    base = (name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
            .split("::")[-1].replace("void ", ""))
    if serve and base.startswith("gemm_sm90_kernel"):
        return "ffn_ln_block"
    for prefix, group in PORT_KERNELS.items():
        if base.startswith(prefix):
            if isinstance(group, tuple):
                args = name.split("<", 1)[1].split(">", 1)[0].split(",")
                flag = next(a.strip() for a in args if a.strip() in ("true", "false"))
                return group[flag == "true"]
            return group
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cuBLAS products"
    return "other (elementwise, reductions, copies)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_train_step.json")
    ap.add_argument("--model", choices=("stonkgs", "stonkgs-finetune", "protstonkgs"),
                    default="stonkgs")
    ap.add_argument("--serve", action="store_true", help="trace the engine's embed batches")
    ap.add_argument("--int8", action="store_true",
                    help="with --serve: the engine on quantize_params output")
    ap.add_argument("--heads", type=int, default=12,
                    help="attention heads of the trunk's width (the published 12)")
    args = ap.parse_args()
    if args.int8 and not args.serve:
        ap.error("--int8 traces int8 serving: pass --serve")
    if args.serve and args.model == "stonkgs-finetune":
        ap.error("--serve traces the engines: pass --model stonkgs or protstonkgs")
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(chip_smoke.SOURCES)
    if args.serve:
        embed = _prot_embed if args.model == "protstonkgs" else _stonkgs_embed
        run, batch_size = embed(args.int8, args.heads)
    else:
        run, batch_size = {"stonkgs": _stonkgs_train, "protstonkgs": _prot_train,
                           "stonkgs-finetune": functools.partial(_stonkgs_train, True)
                           }[args.model](heads=args.heads)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        print("profile_train_step: the trace holds no device time", file=sys.stderr)
        return 1
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key, args.serve),
                              {"ms_per_step": 0.0, "launches_per_step": 0})
        g["ms_per_step"] += e.self_device_time_total / 1e3 / STEPS
        g["launches_per_step"] += e.count / STEPS
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
    # the host's side: the operators that take the most CPU time
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=20))
    step_ms = wall_ms / STEPS
    busy = device_ms / wall_ms
    mode = ((" int8" if args.int8 else "") + (" embed" if args.serve else "")
            + (f" {args.heads} heads" if args.heads != 12 else ""))
    print(f"# {args.model}{mode}: {STEPS} steps, B={batch_size}: "
          f"{step_ms!r} ms a step on the "
          f"host clock, device time {device_ms / STEPS!r} ms a step; device busy "
          f"{busy!r}, idle {1 - busy!r}")
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_step"]):
        print(f"# {name}: {g['ms_per_step']!r} ms/step, {g['launches_per_step']!r} "
              f"launches/step, {g['ms_per_step'] / step_ms!r} of the step")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:40]
    out.write_text(json.dumps({
        "card": card, "model": args.model, "serve": args.serve, "int8": args.int8,
        "heads": args.heads,
        "batch": batch_size,
        "steps": STEPS, "step_ms": step_ms,
        "device_ms_per_step": device_ms / STEPS, "device_busy": busy,
        "groups": groups,
        "kernels": [{"name": e.key, "group": group_of(e.key, args.serve),
                     "ms_per_step": e.self_device_time_total / 1e3 / STEPS,
                     "launches_per_step": e.count / STEPS} for e in top]}, indent=1))
    return 0


def _stonkgs_train(finetune: bool = False, heads: int = 12):
    """One STonKGs train step at B=32, synchronised through its loss; with
    ``finetune`` a fine-tuning step (a classifier head, two labels,
    ``classification_loss``) at B=8."""
    cfg = STonKGsConfig(bert=BertConfig(num_attention_heads=heads), kg_vocab_size=100_000,
                        num_labels=2 if finetune else None)
    gen = torch.Generator().manual_seed(0)
    params = stonkgs.init_stonkgs_params(gen, cfg, with_classifier=finetune)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, cfg.bert.hidden_size, generator=gen)
    tx = AdamW(total_steps=1000)
    state = pretraining.init_train_state(params_to(params, "cuda"), tx)
    if finetune:
        B = chip_smoke.FT_BATCH
        step = pretraining.make_train_step(cfg, tx, loss_fn=stonkgs.classification_loss,
                                           compute_dtype=torch.bfloat16)
        feats = {**chip_smoke._features(cfg, B), "labels": np.arange(B) % 2}
    else:
        B = chip_smoke.TRAIN_BATCH
        step = pretraining.make_train_step(cfg, tx, compute_dtype=torch.bfloat16)
        feats = chip_smoke._pretraining_features(cfg, B)
    batch = pretraining.to_device(feats, "cuda")

    def run():
        _, m = step(state, batch)
        float(m["loss"])
    return run, B


def _prot_cfg(heads: int):
    """chip_smoke.py's ProtSTonKGs config with the trunk in ``heads`` heads."""
    cfg = chip_smoke._prot_cfg()
    return cfg.replace(trunk=dataclasses.replace(cfg.trunk, num_attention_heads=heads))


def _prot_train(heads: int = 12):
    """One ProtSTonKGs train step at B=2 with the training plan."""
    cfg = _prot_cfg(heads)
    params = chip_smoke._prot_params(cfg, seed=0)
    tx = AdamW(total_steps=1000)
    state = pretraining.init_train_state(params_to(params, "cuda"), tx)
    loss_fn = functools.partial(protstonkgs.pretraining_loss,
                                rand_attn=chip_smoke._train_plan(cfg))
    step = pretraining.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=torch.bfloat16)
    B = chip_smoke.PROT_TRAIN_BATCH
    batch = pretraining.to_device(chip_smoke._prot_features(cfg, B, labels=True), "cuda")

    def run():
        _, m = step(state, batch)
        float(m["loss"])
    return run, B


def _serving_params(params, int8: bool):
    """The engine's parameters on the card in bf16, quantized first (on
    the card, from fp32) with ``int8``."""
    if int8:
        params = quantize_params(params_to(params, "cuda"))
    return params_to(params, "cuda", torch.bfloat16)


def _stonkgs_embed(int8: bool, heads: int = 12):
    """One STonKGs embed batch of 128 (bf16), synchronised by the copy of
    its output to the host."""
    cfg = STonKGsConfig(bert=BertConfig(num_attention_heads=heads), kg_vocab_size=100_000)
    gen = torch.Generator().manual_seed(0)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = 0.05 * torch.randn(cfg.kg_table_size, cfg.bert.hidden_size,
                                               generator=gen)
    B = chip_smoke.BATCH
    engine = STonKGsEngine(cfg=cfg, params=_serving_params(params, int8), batch_size=B)
    feats = chip_smoke._features(cfg, B)

    def run():
        engine.embed(feats)
    return run, B


def _prot_embed(int8: bool, heads: int = 12):
    """One ProtSTonKGs embed batch of 8 (bf16), synchronised by the copy
    of its output to the host."""
    cfg = _prot_cfg(heads)
    params = chip_smoke._prot_params(cfg, seed=0, dtype=torch.float32 if int8 else torch.bfloat16)
    B = chip_smoke.PROT_BATCH
    engine = ProtSTonKGsEngine(cfg=cfg, params=_serving_params(params, int8), batch_size=B)
    feats = chip_smoke._prot_features(cfg, B)

    def run():
        engine.embed(feats)
    return run, B


if __name__ == "__main__":
    sys.exit(main())
