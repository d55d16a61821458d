"""Where the time of one pre-training step goes, on one CUDA card.

Run from the root of a checkout, with one CUDA card visible:

    python3 profile_train_step.py [--out profile_train_step.json]

Builds the port's kernels, makes the full-width STonKGs model of
``chip_smoke.py`` (BERT-base backbone and trunk, 256 + 256, KG vocabulary
100,000, random seeded weights, fp32 parameters), runs two warm-up steps
of ``make_train_step`` at B=32 in bf16, then traces three steps with
``torch.profiler`` (each step synchronised through its loss).  It prints
the device time by kernel, the device time by group (the port's kernels,
cuBLAS products, everything else), and the device's busy share of the
traced wall time (the sum of kernel times over the wall time: one stream,
so kernels do not overlap), and writes the groups to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.ops import _build
from stonkgs_tpu_torch.train import pretraining
from stonkgs_tpu_torch.train.optimizer import AdamW
from stonkgs_tpu_torch.utils.convert import params_to

# kernel-name prefixes of the port's own CUDA kernels (csrc/*.cu)
PORT_KERNELS = {
    "attn_fwd_kernel": "flash_attention_train_fwd",
    "attn_bwd_delta_kernel": "flash_attention_train_bwd",
    "attn_bwd_dq_kernel": "flash_attention_train_bwd",
    "attn_bwd_dkdv_kernel": "flash_attention_train_bwd",
    "ffn_fwd_kernel": "ffn_train_fwd",
    "ffn_bwd_kernel": "ffn_train_bwd",
}
STEPS = 3  # traced steps
# cuBLAS kernels on Hopper are named nvjet_*, sm90_xmma_gemm_* or *gemm*
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")


def group_of(name: str) -> str:
    """The group a device kernel's time is booked to."""
    base = name.split("<")[0].split("::")[-1].replace("void ", "")
    for prefix, group in PORT_KERNELS.items():
        if base.startswith(prefix):
            return group
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cuBLAS products"
    return "other (elementwise, reductions, copies)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_train_step.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(chip_smoke.SOURCES)

    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=100_000)
    gen = torch.Generator().manual_seed(0)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, cfg.bert.hidden_size, generator=gen)
    params = params_to(params, "cuda")
    tx = AdamW(total_steps=1000)
    state = pretraining.init_train_state(params, tx)
    step = pretraining.make_train_step(cfg, tx, compute_dtype=torch.bfloat16)
    batch = pretraining.to_device(
        chip_smoke._pretraining_features(cfg, chip_smoke.TRAIN_BATCH), "cuda")
    for _ in range(2):
        state, m = step(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, m = step(state, batch)
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        print("profile_train_step: the trace holds no device time", file=sys.stderr)
        return 1
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key), {"ms_per_step": 0.0, "launches_per_step": 0})
        g["ms_per_step"] += e.self_device_time_total / 1e3 / STEPS
        g["launches_per_step"] += e.count / STEPS
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
    step_ms = wall_ms / STEPS
    busy = device_ms / wall_ms
    print(f"# {STEPS} steps, B={chip_smoke.TRAIN_BATCH}: {step_ms!r} ms a step on the "
          f"host clock, device time {device_ms / STEPS!r} ms a step; device busy "
          f"{busy!r}, idle {1 - busy!r}")
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_step"]):
        print(f"# {name}: {g['ms_per_step']!r} ms/step, {g['launches_per_step']!r} "
              f"launches/step, {g['ms_per_step'] / step_ms!r} of the step")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:40]
    out.write_text(json.dumps({
        "card": card, "steps": STEPS, "step_ms": step_ms,
        "device_ms_per_step": device_ms / STEPS, "device_busy": busy,
        "groups": groups,
        "kernels": [{"name": e.key, "group": group_of(e.key),
                     "ms_per_step": e.self_device_time_total / 1e3 / STEPS,
                     "launches_per_step": e.count / STEPS} for e in top]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
