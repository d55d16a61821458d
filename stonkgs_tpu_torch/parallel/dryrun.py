"""Multi-process dry run of the port's sharded pre-training at tiny shapes.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``
(``:78-221``): :func:`dryrun_multichip` spawns ``n_ranks`` processes
(:func:`stonkgs_tpu_torch.parallel.multihost.launch`) and runs its phases
on a {data, model} mesh (``model`` 2 when ``n_ranks`` is even):

1. ``pretrain`` with vocabularies of 131 and 151, which the mesh does not
   divide (the KG table and the decoders are padded), gradient
   accumulation over 2 micro-batches and a checkpoint at step 2;
2. the resume from that checkpoint to step 4;
3. the pooled output through the row-split KG table;
4. a pure-data FSDP phase (``fsdp=True`` on an ``n_ranks x 1`` mesh);
5. ProtSTonKGs (text + KG + protein through the block-sparse BigBird
   trunk) and the TransE layout (text + 4 slots) on the first mesh.

It prints one summary line.  The model is 64 wide, and its ProtSTonKGs
phase runs BigBird at a head width the card's block-sparse kernels do not
take (they take 64), so this runs at ``device="cpu"`` (the plain
versions); ``chip_smoke.py`` runs the sharded paths at full width on the
card.

Run it with ``python -m stonkgs_tpu_torch.parallel.dryrun 4``.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import tempfile

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.models import protstonkgs, stonkgs
from stonkgs_tpu_torch.parallel import multihost, tp
from stonkgs_tpu_torch.parallel.mesh import make_mesh, shard_batch
from stonkgs_tpu_torch.train.pretraining import PretrainingConfig, pretrain, to_device
from stonkgs_tpu_torch.utils.convert import params_to


def _example_batch(cfg: STonKGsConfig, n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    text = rng.integers(0, cfg.bert.vocab_size, (n, cfg.text_len))
    ent = rng.integers(0, cfg.kg_vocab_size, (n, cfg.entity_len))
    return {
        "input_ids": np.concatenate([text, ent], 1).astype(np.int64),
        "attention_mask": np.ones((n, cfg.seq_len), np.int64),
        "token_type_ids": np.concatenate([np.zeros((n, cfg.text_len), np.int64),
                                          np.ones((n, cfg.entity_len), np.int64)], 1),
    }


def _pretraining_rows(cfg: STonKGsConfig, n: int, rng, seed: int, elm_slots) -> dict:
    feats = _example_batch(cfg, n, seed)
    mlm = np.full((n, cfg.text_len), -100, np.int64)
    elm = np.full((n, cfg.entity_len), -100, np.int64)
    mlm[:, 2:4] = rng.integers(0, cfg.bert.vocab_size, (n, 2))
    elm[:, elm_slots] = rng.integers(0, cfg.kg_vocab_size, (n, elm_slots.stop - elm_slots.start))
    feats.update(masked_lm_labels=mlm, ent_masked_lm_labels=elm,
                 next_sentence_labels=rng.integers(0, 2, (n,)))
    return feats


def _stonkgs_cfg(entity_len: int) -> STonKGsConfig:
    return STonKGsConfig(
        bert=BertConfig(vocab_size=131, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=32),
        kg_vocab_size=151, text_len=16, entity_len=entity_len)


def _params(cfg: STonKGsConfig, seed: int, device) -> dict:
    gen = torch.Generator().manual_seed(seed)
    params = stonkgs.init_stonkgs_params(gen, cfg)
    params["kg_backbone"] = torch.randn(cfg.kg_table_size, cfg.bert.hidden_size, generator=gen)
    return params_to(params, device)


def _finite(label: str, values) -> list:
    for v in values:
        if not np.isfinite(v):
            raise FloatingPointError(f"{label}: non-finite loss {v}")
    return values


def _rank_phases(n_ranks: int, ckpt_dir: str, device: str) -> dict:
    """Every phase on this rank; returns the logged losses and shapes."""
    device = multihost.local_device() if device == "cuda" else torch.device(device)
    n_model = 2 if n_ranks % 2 == 0 else 1
    n_data = n_ranks // n_model
    mesh = make_mesh(n_data, n_model)
    cfg = _stonkgs_cfg(16)
    params = _params(cfg, 0, device)
    rng = np.random.default_rng(0)
    feats = _pretraining_rows(cfg, 8 * n_data, rng, 0, slice(3, 5))

    losses = []
    run = PretrainingConfig(learning_rate=1e-3, max_steps=2, micro_batch_size=n_data,
                            grad_accumulation_steps=2, save_steps=2, log_steps=1,
                            compute_dtype="float32")
    state = pretrain(cfg, params, feats, run, mesh=mesh, checkpoint_dir=ckpt_dir,
                     log_fn=lambda s, m: losses.append(m["loss"]))
    assert state.step == 2, state.step
    state = pretrain(cfg, params, feats, dataclasses.replace(run, max_steps=4), mesh=mesh,
                     checkpoint_dir=ckpt_dir, log_fn=lambda s, m: losses.append(m["loss"]))
    assert state.step == 4 and len(losses) == 4, (state.step, losses)

    batch = to_device(shard_batch(_example_batch(cfg, 2 * n_data), mesh), device)
    with torch.no_grad():
        pooled = stonkgs.pooler_output(state.params, cfg, batch,
                                       tp_mesh=mesh if tp.has_model_axis(mesh) else None)
    assert pooled.shape == (2, cfg.bert.hidden_size) and bool(torch.isfinite(pooled).all())

    fsdp_mesh = make_mesh(n_ranks, 1)
    fsdp_losses = []
    fstate = pretrain(cfg, params, feats,
                      dataclasses.replace(run, max_steps=2, fsdp=True, fsdp_min_size=256,
                                          micro_batch_size=n_ranks, grad_accumulation_steps=1,
                                          save_steps=5000),
                      mesh=fsdp_mesh, log_fn=lambda s, m: fsdp_losses.append(m["loss"]))
    assert fstate.step == 2 and fstate.layout.has_fsdp

    return {"losses": _finite("stonkgs", losses),
            "pooled": tuple(pooled.shape),
            "fsdp_losses": _finite("fsdp", fsdp_losses),
            "prot_losses": _finite("prot", _prot_phase(mesh, n_data, rng, device)),
            "transe_losses": _finite("transe", _transe_phase(mesh, n_data, rng, device)),
            "mesh": (n_data, n_model)}


def _prot_phase(mesh, n_data: int, rng, device) -> list:
    """ProtSTonKGs on the dp x tp mesh: 12 text + 4 entity + 16 protein
    tokens, block size 4, so the trunk runs its sparse pattern."""
    pcfg = ProtSTonKGsConfig(
        trunk=BigBirdConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=64,
                            max_position_embeddings=64, block_size=4, num_random_blocks=1,
                            attention_type="block_sparse"),
        lm=BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64, max_position_embeddings=8),
        prot=BertConfig(vocab_size=30, hidden_size=16, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=32, max_position_embeddings=16),
        lm_vocab_size=128, kg_vocab_size=150, prot_vocab_size=30,
        kg_start_idx=12, prot_start_idx=16, seq_len=32, sep_id=102, mask_id=103, unk_id=100)
    gen = torch.Generator().manual_seed(2)
    params = protstonkgs.init_protstonkgs_params(
        gen, pcfg, kg_table=torch.randn(pcfg.kg_table_size, 32, generator=gen))
    n = 4 * n_data
    mlm = np.full((n, 12), -100, np.int64)
    elm = np.full((n, 4), -100, np.int64)
    plm = np.full((n, 16), -100, np.int64)
    mlm[:, 1:3] = rng.integers(0, 128, (n, 2))
    elm[:, 0] = rng.integers(0, 150, n)
    plm[:, 2:4] = rng.integers(0, 30, (n, 2))
    feats = {"input_ids": np.concatenate([rng.integers(0, 128, (n, 12)),
                                          rng.integers(0, 150, (n, 4)),
                                          rng.integers(0, 30, (n, 16))], 1),
             "attention_mask": np.ones((n, 32), np.int64),
             "masked_lm_labels": mlm, "ent_masked_lm_labels": elm,
             "prot_masked_lm_labels": plm}
    losses = []
    run = PretrainingConfig(learning_rate=1e-3, max_steps=2, micro_batch_size=2 * n_data,
                            log_steps=1, compute_dtype="float32")
    state = pretrain(pcfg, params_to(params, device), feats, run, mesh=mesh,
                     log_fn=lambda s, m: losses.append(m["loss"]),
                     loss_fn=functools.partial(protstonkgs.pretraining_loss))
    assert state.step == 2 and len(losses) == 2
    return losses


def _transe_phase(mesh, n_data: int, rng, device) -> list:
    """The TransE layout ([h, r, t, SEP] entity half) on the dp x tp mesh."""
    cfg = _stonkgs_cfg(4)
    feats = _pretraining_rows(cfg, 4 * n_data, rng, 4, slice(1, 2))
    losses = []
    run = PretrainingConfig(learning_rate=1e-3, max_steps=2, micro_batch_size=2 * n_data,
                            log_steps=1, compute_dtype="float32")
    state = pretrain(cfg, _params(cfg, 3, device), feats, run, mesh=mesh,
                     log_fn=lambda s, m: losses.append(m["loss"]))
    assert state.step == 2 and len(losses) == 2
    return losses


def dryrun_multichip(n_ranks: int, device: str = "cpu") -> dict:
    """Run every phase on ``n_ranks`` spawned ranks (gloo on the CPU) and
    print one summary line; returns rank 0's results.  The ranks must
    agree on every logged loss (the metrics are the global batch's)."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = multihost.launch(_rank_phases, n_ranks, (n_ranks, ckpt_dir, device),
                                   backend="gloo" if device == "cpu" else None, threads=1)
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        for key in ("losses", "fsdp_losses", "prot_losses", "transe_losses"):
            if not np.allclose(other[key], first[key], rtol=1e-6, atol=0):
                raise AssertionError(f"rank {r} logged {key} {other[key]}, rank 0 {first[key]}")
    n_data, n_model = first["mesh"]

    def fmt(v):
        return [round(float(x), 4) for x in v]

    print(f"dryrun_multichip({n_ranks}): mesh {n_data}x{n_model} steps=4 (ckpt resume at 2) "
          f"losses={fmt(first['losses'])} pooled={first['pooled']} "
          f"fsdp_losses={fmt(first['fsdp_losses'])} prot_losses={fmt(first['prot_losses'])} "
          f"transe_losses={fmt(first['transe_losses'])} OK", flush=True)
    return first


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
