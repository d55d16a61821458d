"""Pre-training driver (reference ``models/stonkgs_pretraining.py:103-244``).

The port of the JAX package's ``stonkgs_tpu/cli/pretrain.py``: loads
preprocessed features (a memmap store, a pickle, or a TSV with stringified
int lists), builds the model (the KG table from node2vec embeddings, the
LM backbone from a checkpoint or seeded random weights, both frozen), and
runs :func:`~stonkgs_tpu_torch.train.pretraining.pretrain` with
checkpoints and auto-resume under ``output_dir/checkpoints``, on the card
unless the caller asks for the CPU.

pandas is imported only to read a pickle or a TSV; the memmap store, the
KG embeddings (:func:`~stonkgs_tpu_torch.data.artifacts.read_tsv`) and the
LM checkpoint need only torch and numpy.

Several cards train as several processes, one a card::

    torchrun --nproc_per_node=N your_script.py   # which calls run_pretraining(...)

:func:`run_pretraining` starts the process group from torchrun's variables
(:func:`stonkgs_tpu_torch.parallel.multihost.initialize`) and builds the mesh
as the JAX package does (``cli/pretrain.py:190-199``): ``n_model_shards``
ranks split the KG table and the decoders, and the data axis is the
largest divisor of the batch that fits the rest; ``fsdp`` splits the large
replicated leaves over it.  The main rank alone logs, writes the
checkpoints and exports.  One process with several cards visible trains
on one of them: a JAX process drives every card of its host, a torch
process one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
from stonkgs_tpu_torch.data.artifacts import parse_vectors, read_tsv
from stonkgs_tpu_torch.data.filters import fix_stringified_lists
from stonkgs_tpu_torch.data.memmap_dataset import MemmapFeatureStore
from stonkgs_tpu_torch.models import protstonkgs, stonkgs
from stonkgs_tpu_torch.parallel import multihost
from stonkgs_tpu_torch.parallel.mesh import Mesh, make_mesh
from stonkgs_tpu_torch.train.pretraining import PretrainingConfig, pretrain, resolve_train_impl
from stonkgs_tpu_torch.utils.convert import params_to
from stonkgs_tpu_torch.utils.hf_export import save_pretrained
from stonkgs_tpu_torch.utils.hf_loader import bert_params_from_state_dict, load_state_dict
from stonkgs_tpu_torch.utils.logging import RunLogger

logger = logging.getLogger(__name__)

FEATURE_KEYS = ("input_ids", "attention_mask", "token_type_ids",
                "masked_lm_labels", "ent_masked_lm_labels",
                "prot_masked_lm_labels", "next_sentence_labels")


def load_preprocessed_dataset(path: str) -> Dict[str, np.ndarray]:
    """A memmap store directory, a pickle or a TSV of preprocessed
    features -> dict of (N, ...) arrays (a store's are its memmaps).

    The reference's ``_load_pre_training_data``
    (``stonkgs_pretraining.py:37-52``), with the TSV's stringified lists
    repaired as ``fix_broken_pretraining_dataset.py`` does."""
    if os.path.isdir(path):
        store = MemmapFeatureStore(path)
        return {k: store[k] for k in store.keys()}
    import pandas as pd

    if path.endswith(".pkl") or path.endswith(".pickle"):
        df = pd.read_pickle(path)
    else:
        df = fix_stringified_lists(pd.read_csv(path, sep="\t"))
    out = {}
    for key in FEATURE_KEYS:
        if key not in df.columns:
            continue
        col = df[key]
        if np.isscalar(col.iloc[0]) or isinstance(col.iloc[0], (int, np.integer)):
            out[key] = col.to_numpy(np.int64)
        else:
            out[key] = np.stack([np.asarray(v, np.int64) for v in col])
    return out


def _read_kg_vectors(path: str) -> np.ndarray:
    """A headerless node2vec TSV (name, then the vector) -> (N, H) float32."""
    return parse_vectors(read_tsv(path)[1])


def _device(device: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_pretraining: no CUDA device; pass device='cpu' to "
                               "train on the CPU")
        if dist.is_initialized():
            return multihost.local_device()
        if torch.cuda.device_count() > 1:
            logger.info("%d cards visible: this process trains on %s; launch one process "
                        "a card with torchrun --nproc_per_node=%d to train on all of them",
                        torch.cuda.device_count(), device, torch.cuda.device_count())
    return device


def _make_mesh(batch_size: int, n_model_shards: int, fsdp: bool) -> Optional[Mesh]:
    """The run's mesh over the process group (None for one process): the
    model axis of ``n_model_shards``, the data axis the largest divisor of
    the batch that is at most ``world // n_model_shards``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_model_shards > world:
        raise ValueError(f"n_model_shards {n_model_shards} exceeds the {world} ranks of the "
                         "process group: launch one process a card with torchrun")
    if world == 1:
        if fsdp:
            logger.info("fsdp has no data axis to split over in a single process")
        return None
    max_data = world // n_model_shards
    n_data = max(d for d in range(1, max_data + 1) if batch_size % d == 0)
    if n_data * n_model_shards != world:
        raise ValueError(f"batch {batch_size} over {world} ranks: a {n_data}x{n_model_shards} "
                         "mesh would leave ranks idle; pick a batch the data axis divides")
    return make_mesh(n_data, n_model_shards)


def _main_logger(mesh: Optional[Mesh], **kw):
    """The run's logger on the main rank, nothing elsewhere."""
    return RunLogger(**kw) if mesh is None or mesh.is_main else contextlib.nullcontext()


def _export(state, cfg, export_hf_dir: str, mesh: Optional[Mesh]) -> None:
    params = state.layout.gather(state.params) if state.layout is not None else state.params
    if mesh is None or mesh.is_main:
        save_pretrained(params, cfg, export_hf_dir)
        logger.info("exported HF checkpoint to %s", export_hf_dir)


def _frozen_to_bf16(params: dict, keys) -> None:
    """Store the frozen backbones' floating leaves in bf16, in place."""
    for key in keys:
        params[key] = params_to(params[key], dtype=torch.bfloat16)


def stonkgs_pretraining_config(features: Dict[str, np.ndarray], variant: str,
                               hidden: int, vocab_size: int,
                               num_hidden_layers: Optional[int] = None):
    """The STonKGs config :func:`run_pretraining` derives: the layout from
    the data (``transe``: text + 4), BERT-base when the KG vectors are
    768 wide, else a smoke-scale config of that width (2 layers unless
    ``num_hidden_layers``), the KG vocabulary from the largest entity id."""
    seq_len = features["input_ids"].shape[1]
    if variant == "transe":
        text_len, entity_len = seq_len - 4, 4
    else:
        text_len = entity_len = seq_len // 2
    if hidden == 768:
        bert_cfg = BertConfig(vocab_size=vocab_size,
                              max_position_embeddings=max(seq_len, 512))
        if num_hidden_layers is not None:
            bert_cfg = dataclasses.replace(bert_cfg, num_hidden_layers=num_hidden_layers)
    else:
        bert_cfg = BertConfig(
            vocab_size=vocab_size, hidden_size=hidden,
            num_hidden_layers=num_hidden_layers or 2,
            num_attention_heads=max(hidden // 64, 2),
            intermediate_size=hidden * 4,
            max_position_embeddings=max(seq_len, 512),
        )
    kg_vocab = int(features["input_ids"][:, text_len:].max()) + 1
    return STonKGsConfig(bert=bert_cfg, kg_vocab_size=kg_vocab,
                         text_len=text_len, entity_len=entity_len)


def run_pretraining(
    dataset_path: str,
    *,
    variant: str = "stonkgs",
    kg_embedding_path: Optional[str] = None,
    lm_checkpoint: Optional[str] = None,
    vocab_file: Optional[str] = None,
    batch_size: int = 8,
    lr: float = 1e-4,
    max_steps: int = 200,
    gradient_accumulation_steps: int = 1,
    save_steps: int = 5000,
    save_total_limit: int = 5,
    log_steps: int = 100,
    output_dir: str = "stonkgs-pretraining",
    n_model_shards: int = 1,
    compute_dtype: str = "bfloat16",
    remat="auto",
    attention_impl: str = "auto",
    fsdp: bool = False,
    frozen_bf16: bool = True,
    export_hf_dir: Optional[str] = None,
    local_rank: int = -1,  # accepted and ignored, like the reference CLI
    num_hidden_layers: Optional[int] = None,
    seed: int = 0,
    device: str = "cuda",
):
    """Pre-train STonKGs, TransESTonKGs (``variant="transe"``) or
    ProtSTonKGs (``variant="prot"``) from preprocessed features; returns
    the final train state.  A second call with the same ``output_dir``
    resumes from its newest checkpoint.

    Under a process group of several ranks (torchrun, or one started
    before the call) every rank calls this with the same arguments; the
    returned state holds the rank's slices and their layout."""
    multihost.initialize()
    device = _device(device)
    mesh = _make_mesh(batch_size, n_model_shards, fsdp)
    features = load_preprocessed_dataset(dataset_path)
    logger.info("dataset: %d examples, seq len %d (%.1f MB)",
                len(features["input_ids"]), features["input_ids"].shape[1],
                sum(v.nbytes for v in features.values()) / 1e6)

    if variant == "prot":
        if attention_impl not in (None, "auto"):
            logger.warning("attention_impl %s is ignored for variant=prot "
                           "(the BigBird trunk selects its own kernels)", attention_impl)
        return _run_prot_pretraining(
            features, kg_embedding_path=kg_embedding_path,
            batch_size=batch_size, lr=lr, max_steps=max_steps,
            gradient_accumulation_steps=gradient_accumulation_steps,
            save_steps=save_steps, save_total_limit=save_total_limit,
            log_steps=log_steps, output_dir=output_dir, compute_dtype=compute_dtype,
            remat=remat, seed=seed, device=device, mesh=mesh, fsdp=fsdp)
    if variant not in ("stonkgs", "transe"):
        raise ValueError(f"unknown variant {variant!r}: 'stonkgs', 'transe' or 'prot'")

    kg_vectors = _read_kg_vectors(kg_embedding_path) if kg_embedding_path else None
    # the model's hidden size is the node2vec dimension (768 in production)
    hidden = int(kg_vectors.shape[1]) if kg_vectors is not None else 768
    vocab_size = 28996  # BioBERT's
    if vocab_file:
        with open(vocab_file) as f:
            vocab_size = sum(1 for _ in f)
    cfg = stonkgs_pretraining_config(features, variant, hidden, vocab_size,
                                     num_hidden_layers)

    params = stonkgs.init_stonkgs_params(torch.Generator().manual_seed(seed), cfg)
    if lm_checkpoint:
        sd = load_state_dict(lm_checkpoint)
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        params["lm_backbone"] = bert_params_from_state_dict(sd, cfg.bert, prefix)
        del sd
    params = params_to(params, device)
    if kg_vectors is not None:
        params["kg_backbone"] = stonkgs.build_kg_table(
            params["lm_backbone"], cfg.bert, kg_vectors)
    if frozen_bf16 and compute_dtype == "bfloat16":
        # the frozen backbones are read only: bf16 storage halves their
        # memory and leaves the bf16 compute path as it is
        _frozen_to_bf16(params, ("lm_backbone", "kg_backbone"))

    remat, attention_impl = resolve_train_impl(remat, attention_impl, mesh)
    run_cfg = PretrainingConfig(
        learning_rate=lr, max_steps=max_steps, micro_batch_size=batch_size,
        grad_accumulation_steps=gradient_accumulation_steps,
        save_steps=save_steps, save_total_limit=save_total_limit, log_steps=log_steps,
        compute_dtype=compute_dtype, seed=seed, remat=remat, attention_impl=attention_impl,
        fsdp=fsdp,
    )
    with _main_logger(mesh, log_dir=output_dir, experiment="stonkgs-pretraining") as log:
        if log is not None:
            for k, v in vars(run_cfg).items():
                log.log_param(k, v)
        state = pretrain(
            cfg, params, features, run_cfg, mesh=mesh,
            checkpoint_dir=os.path.join(output_dir, "checkpoints"),
            log_fn=(lambda step, m: log.log_metrics(m, step)) if log is not None else None,
        )
    if export_hf_dir:
        _export(state, cfg, export_hf_dir, mesh)
    return state


def prot_pretraining_config(features: Dict[str, np.ndarray], hidden: int):
    """The ProtSTonKGs config :func:`run_pretraining` derives: the layout
    from the label columns, the published widths when the KG vectors are
    768 wide, else a smoke-scale config of that width."""
    text_len = features["masked_lm_labels"].shape[1]
    ent_len = features["ent_masked_lm_labels"].shape[1]
    prot_len = features["prot_masked_lm_labels"].shape[1]
    seq_len = features["input_ids"].shape[1]
    if text_len + ent_len + prot_len != seq_len:
        raise ValueError(f"label lengths {text_len} + {ent_len} + {prot_len} != "
                         f"sequence length {seq_len}")
    ent_ids = features["input_ids"][:, text_len: text_len + ent_len]
    prot_ids = features["input_ids"][:, text_len + ent_len:]
    kg_vocab = int(ent_ids.max()) + 1
    prot_vocab = max(int(prot_ids.max()) + 1, 30)
    if hidden == 768:
        trunk = BigBirdConfig(max_position_embeddings=max(seq_len, 4096))
        lm = BertConfig()
        prot = BertConfig(vocab_size=prot_vocab, hidden_size=1024,
                          num_hidden_layers=30, num_attention_heads=16,
                          intermediate_size=4096,
                          max_position_embeddings=max(prot_len, 40000))
    else:
        trunk = BigBirdConfig(
            vocab_size=128, hidden_size=hidden,
            num_hidden_layers=2, num_attention_heads=max(hidden // 32, 2),
            intermediate_size=hidden * 4,
            max_position_embeddings=max(seq_len, 64),
            block_size=max(seq_len // 8, 4), num_random_blocks=1)
        lm = BertConfig(vocab_size=28996, hidden_size=hidden,
                        num_hidden_layers=2,
                        num_attention_heads=max(hidden // 32, 2),
                        intermediate_size=hidden * 4,
                        max_position_embeddings=max(text_len // 3, 8))
        prot = BertConfig(vocab_size=prot_vocab, hidden_size=hidden,
                          num_hidden_layers=2,
                          num_attention_heads=max(hidden // 32, 2),
                          intermediate_size=hidden * 4,
                          max_position_embeddings=max(prot_len, 8))
    return ProtSTonKGsConfig(
        trunk=trunk, lm=lm, prot=prot,
        lm_vocab_size=lm.vocab_size, kg_vocab_size=kg_vocab,
        prot_vocab_size=prot_vocab,
        kg_start_idx=text_len, prot_start_idx=text_len + ent_len,
        seq_len=seq_len,
    )


def _run_prot_pretraining(
    features,
    *,
    kg_embedding_path=None,
    batch_size=8,
    lr=1e-4,
    max_steps=200,
    gradient_accumulation_steps=1,
    save_steps=5000,
    save_total_limit=5,
    log_steps=100,
    output_dir="protstonkgs-pretraining",
    compute_dtype="bfloat16",
    remat="auto",
    seed=0,
    device="cuda",
    mesh=None,
    fsdp=False,
):
    """ProtSTonKGs pre-training (tri-modality features; the layout from the
    label columns: text spans the masked_lm labels, KG the ent labels,
    protein the prot labels).  ``remat`` keeps its mode here ("attention"
    checkpoints the BigBird attention sub-blocks), where the JAX package
    turns any mode but none into full-layer remat."""
    kg_vectors = _read_kg_vectors(kg_embedding_path) if kg_embedding_path else None
    hidden = int(kg_vectors.shape[1]) if kg_vectors is not None else 768
    cfg = prot_pretraining_config(features, hidden)
    params = params_to(protstonkgs.init_protstonkgs_params(
        torch.Generator().manual_seed(seed), cfg), device)
    if kg_vectors is not None:
        params["kg_backbone"] = protstonkgs.build_kg_table(
            params["lm_backbone"], cfg, kg_vectors)
    if compute_dtype == "bfloat16":
        # the frozen backbones are read only: bf16 storage halves ~2.3 GB
        _frozen_to_bf16(params, ("lm_backbone", "prot_backbone", "kg_backbone"))
    remat, _ = resolve_train_impl(remat, mesh=mesh)
    run_cfg = PretrainingConfig(
        learning_rate=lr, max_steps=max_steps, micro_batch_size=batch_size,
        grad_accumulation_steps=gradient_accumulation_steps,
        save_steps=save_steps, save_total_limit=save_total_limit, log_steps=log_steps,
        compute_dtype=compute_dtype, seed=seed, remat=remat, fsdp=fsdp,
    )
    with _main_logger(mesh, log_dir=output_dir, experiment="protstonkgs-pretraining") as log:
        state = pretrain(
            cfg, params, features, run_cfg, mesh=mesh,
            checkpoint_dir=os.path.join(output_dir, "checkpoints"),
            log_fn=(lambda step, m: log.log_metrics(m, step)) if log is not None else None,
            loss_fn=protstonkgs.pretraining_loss,
        )
    return state
