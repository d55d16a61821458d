"""The int8 serving mode against bf16: embedding-extraction throughput and
the fidelity of the pooled embeddings, on one CUDA card.

The port of the JAX package's ``benchmarks/bench_int8_embed.py``.  Full
BERT-base STonKGs (256 + 256 tokens, KG vocabulary 100,000) with seeded
random weights; ``quantize_params`` turns every eligible dense into int8
(per-column weight scales, per-row activation absmax) and
``STonKGsEngine.embed`` serves both modes at ``--batch-size`` rows a batch
in bf16.  Prints one JSON line per mode: pairs/s (the median of
``--steps`` timed calls after one of warm-up, each ending in the copy to
the host), and, for int8, the mean cosine of its pooled output against
bf16.  Run::

    python -m stonkgs_tpu_torch.benchmarks.bench_int8_embed [--batch-size 128]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from stonkgs_tpu_torch import STonKGsEngine
from stonkgs_tpu_torch.benchmarks._util import emit, require_cuda
from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.ops.quantization import quantize_params
from stonkgs_tpu_torch.utils.convert import params_to


def synthetic_features(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    """Rows of uniform random ids with a full mask, as the JAX benchmarks'
    ``synthetic_batch``."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, cfg.bert.vocab_size, (n, cfg.text_len))
    ent = rng.integers(0, cfg.kg_vocab_size, (n, cfg.entity_len))
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.ones((n, cfg.seq_len), np.int64),
        "token_type_ids": np.concatenate(
            [np.zeros((n, cfg.text_len), np.int64), np.ones((n, cfg.entity_len), np.int64)], 1),
    }


def main(batch_size: int = 128, steps: int = 5, kg_vocab: int = 100_000,
         seed: int = 0) -> dict:
    """Both modes timed in turns on the same rows; returns each mode's
    record by name."""
    card = require_cuda()
    cfg = STonKGsConfig(bert=BertConfig(), kg_vocab_size=kg_vocab)
    gen = torch.Generator().manual_seed(seed)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = 0.02 * torch.randn(cfg.kg_table_size, cfg.bert.hidden_size,
                                               generator=gen)
    params = params_to(params, "cuda")
    engines = {
        "bf16": STonKGsEngine(cfg=cfg, params=params_to(params, "cuda", torch.bfloat16),
                              batch_size=batch_size),
        "int8": STonKGsEngine(cfg=cfg, params=params_to(quantize_params(params), "cuda",
                                                        torch.bfloat16),
                              batch_size=batch_size),
    }
    del params
    feats = synthetic_features(cfg, batch_size, seed)
    pooled = {name: eng.embed(feats) for name, eng in engines.items()}   # warm-up
    times = {name: [] for name in engines}
    for _ in range(steps):
        for name, eng in engines.items():
            t0 = time.perf_counter()
            eng.embed(feats)
            times[name].append(time.perf_counter() - t0)
    ref, got = pooled["bf16"], pooled["int8"]
    cos = float(np.mean((ref * got).sum(-1)
                        / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))))
    out = {}
    for name in engines:
        dt = statistics.median(times[name])
        extra = {"cosine_vs_bf16": cos} if name == "int8" else {}
        out[name] = emit(
            f"embedding extraction [{name}] (batch {batch_size}, seq {cfg.seq_len}, "
            f"kg_vocab {kg_vocab})", batch_size / dt, "pairs/s", batch_ms=dt * 1e3,
            card=card, **extra)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--kg-vocab", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.batch_size, a.steps, a.kg_vocab, a.seed)
