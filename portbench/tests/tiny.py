"""Tiny cells for the CPU tests: the configurations and traffic of the
benchmark cut to a size a test run holds (2 layers, narrow widths, a
small KG vocabulary and corpus), every other key as the cell has it."""

from __future__ import annotations

import copy
import json

from portbench.harness.spec import Cell, check_traffic, load_cell

NARROW = {"num_hidden_layers": 2, "hidden_size": 32, "intermediate_size": 64,
          "num_attention_heads": 2}


FOUR_RANKS = "stonkgs.pretrain-dp4"


def four_rank_cell() -> Cell:
    """The pre-training cell data-parallel over four ranks (the traffic of
    ``pretrain-b32-dp4``: B=32 a rank), judged by the one-card cell's
    limits; ``BENCHMARK.json`` has no four-card cell yet."""
    cell = copy.deepcopy(load_cell("stonkgs.pretrain"))
    cell.name, cell.chips = FOUR_RANKS, 4
    cell.traffic = json.loads((cell.bench_dir / "traffic" / "pretrain-b32-dp4.json").read_text())
    check_traffic("pretrain-b32-dp4", cell.traffic)
    return cell


def tiny_cell(name: str) -> Cell:
    cell = four_rank_cell() if name == FOUR_RANKS else copy.deepcopy(load_cell(name))
    cfg, tr = cell.config, cell.traffic
    cfg["kg_vocab_size"] = 200
    # the same gain a product as at the published widths
    gain = (768 / NARROW["hidden_size"]) ** 0.5
    for sub in ("bert", "trunk", "lm", "prot"):
        if sub in cfg:
            cfg[sub]["initializer_range"] *= gain
    if cfg["model"] == "stonkgs":
        cfg["bert"].update(NARROW, vocab_size=1200)
        cfg["text_len"] = cfg["entity_len"] = 32
        cfg["bert"]["max_position_embeddings"] = 64
        segs = tr["segments"]
        segs[0]["len"] = 32
        segs[0]["fill"].update(median=10, max=32)
        segs[1]["len"] = segs[3]["len"] = 15
    else:
        for k in ("trunk", "lm", "prot"):
            cfg[k].update(NARROW)
        cfg["lm"]["vocab_size"] = 1200
        cfg["trunk"].update(vocab_size=300, block_size=8, max_position_embeddings=512)
        cfg.update(kg_start_idx=96, prot_start_idx=128, seq_len=512)
        lens = [1, 30, 1, 31, 1, 31, 1, 15, 1, 15, 1, 191, 1, 191, 1]
        for seg, n in zip(tr["segments"], lens):
            seg["len"] = n
            if "fill" in seg:
                seg["fill"].update(median=max(n // 3, 2), min=2, max=n)
    for seg in tr["segments"]:
        if isinstance(seg["tokens"], list) and seg["tokens"][1] > 1200:
            seg["tokens"] = [seg["tokens"][0] // 10, 1200]
    tr["corpus_rows"] = 64 if tr["mode"] == "embed" else 32 * cell.chips
    if tr["mode"] == "embed":
        tr["batch_size"] = min(tr["batch_size"], 4)
        tr["rows_per_request"] = min(tr["rows_per_request"], 8)
        tr["check_rows"] = 6
    else:
        tr["batch_size"] = 4 * cell.chips
        tr["prefetch_depth"] = 2
    return cell
