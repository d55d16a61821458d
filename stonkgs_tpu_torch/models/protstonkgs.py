"""ProtSTonKGs, tri-modality (text + KG + protein) BigBird, in PyTorch.

The port of the JAX package's ``stonkgs_tpu/models/protstonkgs.py``.
Sequence layout: [text 768 | KG 256 | protein 3072] = 4096 tokens into a
BigBird trunk (block-sparse attention).  Three frozen backbones make the
input embeddings; the trunk, the protein projection and the heads train.

Quirks kept on purpose:

* the text part runs through the LM backbone in 3 independent chunks of
  256, each at positions 0..255 and with no attention mask;
* the protein backbone runs with no attention mask;
* the trunk gets no token-type ids (all zeros);
* the KG table's special rows sit at the BigBird tokenizer's sep/mask/unk
  ids (66/67/100) and hold the LM backbone's output for that id;
* the three decoders are bias-free; their bias parameters are kept and
  never applied;
* no NSP objective: the loss is MLM + ELM + ProtLM.

The backbones run under ``torch.no_grad()`` (in training with their
dropout, as the JAX package's ``stop_gradient`` after train-mode
backbones), so they launch forward kernels only; the trainable
``prot_projection`` is applied outside that scope.

Under a mesh (``tp_mesh``) with a model axis the KG table and the three
decoders hold this rank's slices (the JAX package's ``protstonkgs.py:
148-153, 260-278``), as in :mod:`stonkgs_tpu_torch.models.stonkgs`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.config import ProtSTonKGsConfig
from stonkgs_tpu_torch.models import bert, bigbird, stonkgs
from stonkgs_tpu_torch.models.bert import DropoutRng, _init_dense, dense
from stonkgs_tpu_torch.models.heads import (
    classifier_head,
    elm_decode_segment,
    elm_transform,
    init_classifier_head,
    init_elm_head,
)
from stonkgs_tpu_torch.ops.losses import gather_masked_positions, masked_cross_entropy
from stonkgs_tpu_torch.parallel import tp

SEGMENTS = ("text", "entity", "prot")


def init_protstonkgs_params(
    gen: torch.Generator,
    cfg: ProtSTonKGsConfig,
    *,
    with_classifier: bool = False,
    kg_table: Optional[torch.Tensor] = None,
) -> dict:
    """The full parameter tree, fp32 on the CPU, from ``gen``: trunk, the
    LM and protein backbones, the protein projection, the three-segment
    ELM head (``cls``), the KG table (zeros unless ``kg_table`` is given:
    fill it with :func:`build_kg_table`) and, optionally, the
    classifier."""
    params = {
        "trunk": bigbird.init_bigbird_params(gen, cfg.trunk, with_pooler=True),
        "lm_backbone": bert.init_bert_params(gen, cfg.lm, with_pooler=True),
        "prot_backbone": bert.init_bert_params(gen, cfg.prot, with_pooler=True),
        "prot_projection": _init_dense(gen, cfg.prot.hidden_size, cfg.trunk.hidden_size,
                                       cfg.trunk.initializer_range),
        "cls": {"predictions": init_elm_head(
            gen, cfg.trunk, [cfg.lm_vocab_size, cfg.kg_vocab_size, cfg.prot_vocab_size],
            SEGMENTS)},
        "kg_backbone": (kg_table if kg_table is not None
                        else torch.zeros(cfg.kg_table_size, cfg.trunk.hidden_size)),
    }
    if with_classifier:
        if cfg.num_labels is None:
            raise ValueError("with_classifier needs cfg.num_labels")
        params["classifier"] = init_classifier_head(gen, cfg.trunk, cfg.num_labels)
    return params


def build_kg_table(
    lm_params: dict,
    cfg: ProtSTonKGsConfig,
    kg_vectors: np.ndarray,
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(N+3, H) fp32 KG table with its special rows at the BigBird sep,
    mask and unk ids, filled from the LM backbone."""
    return stonkgs.build_kg_table(lm_params, cfg.lm, kg_vectors, compute_dtype=compute_dtype,
                                  special_ids=(cfg.sep_id, cfg.mask_id, cfg.unk_id))


def backbone_embeddings(
    params: dict,
    cfg: ProtSTonKGsConfig,
    input_ids: torch.Tensor,       # (B, seq_len)
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    tp_mesh=None,
) -> torch.Tensor:
    """Three-modality input embeddings (B, seq_len, H): the text chunks
    through the LM backbone, the KG gather and the protein backbone under
    ``torch.no_grad()``, then the trainable projection of the protein
    part."""
    chunk = cfg.kg_start_idx // 3
    B = input_ids.shape[0]
    with torch.no_grad():
        text_in = input_ids[:, : cfg.kg_start_idx].reshape(B * 3, chunk)
        text_emb, _ = bert.bert_model(
            params["lm_backbone"], cfg.lm, input_ids=text_in, deterministic=deterministic,
            rng=rng, compute_dtype=compute_dtype, with_pooler=False)
        text_emb = text_emb.reshape(B, cfg.kg_start_idx, -1)
        ent_ids = input_ids[:, cfg.kg_start_idx: cfg.prot_start_idx]
        table = params["kg_backbone"].to(compute_dtype)
        if tp.has_model_axis(tp_mesh):
            ent_emb = tp.tp_gather(table, ent_ids, tp_mesh)
        else:
            ent_emb = table[ent_ids]
        prot_out, _ = bert.bert_model(
            params["prot_backbone"], cfg.prot, input_ids=input_ids[:, cfg.prot_start_idx:],
            deterministic=deterministic, rng=rng, compute_dtype=compute_dtype,
            with_pooler=False)
    prot_emb = dense(prot_out, params["prot_projection"])
    return torch.cat([text_emb, ent_emb, prot_emb], dim=1)


def trunk_forward(
    params: dict,
    cfg: ProtSTonKGsConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat=False,
    rand_attn=None,
    trunk_attention_type: Optional[str] = None,
    cls_only: bool = False,
    tp_mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbones + BigBird trunk: (sequence_output, pooled).

    ``trunk_attention_type="original_full"`` runs the trunk with dense
    attention, valid only for models trained with it (the engine's
    ``fast_trunk``); the default is the checkpoint's block-sparse."""
    inputs_embeds = backbone_embeddings(params, cfg, input_ids, deterministic=deterministic,
                                        rng=rng, compute_dtype=compute_dtype, tp_mesh=tp_mesh)
    return bigbird.bigbird_model(
        params["trunk"], cfg.trunk, inputs_embeds=inputs_embeds,
        attention_mask=attention_mask, deterministic=deterministic, rng=rng,
        compute_dtype=compute_dtype, remat=remat, with_pooler=True, rand_attn=rand_attn,
        attention_type=trunk_attention_type, cls_only=cls_only)


def pretraining_logits(
    params: dict,
    cfg: ProtSTonKGsConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-shaped outputs: (mlm, elm, prot) dense logits and the
    pooled output; ``kw`` goes to :func:`trunk_forward`."""
    seq, pooled = trunk_forward(params, cfg, input_ids, attention_mask, **kw)
    p = params["cls"]["predictions"]
    t = elm_transform(p, seq, cfg.trunk)
    mlm = elm_decode_segment(p, t[:, : cfg.kg_start_idx], "text")
    elm = elm_decode_segment(p, t[:, cfg.kg_start_idx: cfg.prot_start_idx], "entity")
    prot = elm_decode_segment(p, t[:, cfg.prot_start_idx:], "prot")
    return mlm, elm, prot, pooled


def pretraining_loss(
    params: dict,
    cfg: ProtSTonKGsConfig,
    batch: dict,
    *,
    dense_heads: bool = False,
    **kw,
) -> Tuple[torch.Tensor, dict]:
    """MLM + ELM + ProtLM loss, no NSP (``stonkgs_tpu/models/
    protstonkgs.py:238-285``); ``kw`` goes to :func:`trunk_forward`.

    With ``dense_heads=False`` each segment decodes only its gathered
    masked positions, k = max(int(0.15 · len), 1) slots per segment.
    Returns (loss, {"text_loss", "entity_loss", "prot_loss", "loss"}).
    Under ``tp_mesh`` (in ``kw``) with a model axis every segment decodes
    through the vocab-parallel loss."""
    mesh = kw.get("tp_mesh")
    seq, _ = trunk_forward(params, cfg, batch["input_ids"], batch.get("attention_mask"), **kw)
    p = params["cls"]["predictions"]
    segs = [
        ("text", (0, cfg.kg_start_idx), cfg.lm_vocab_size, batch["masked_lm_labels"]),
        ("entity", (cfg.kg_start_idx, cfg.prot_start_idx), cfg.kg_vocab_size,
         batch["ent_masked_lm_labels"]),
        ("prot", (cfg.prot_start_idx, cfg.seq_len), cfg.prot_vocab_size,
         batch["prot_masked_lm_labels"]),
    ]
    losses = {}
    total = 0.0
    for name, (a, b), vocab, labels in segs:
        if dense_heads:
            h, lab = seq[:, a:b], labels
        else:
            h, lab, _ = gather_masked_positions(seq[:, a:b], labels, max(int((b - a) * 0.15), 1))
        t = elm_transform(p, h, cfg.trunk)
        if tp.has_model_axis(mesh):
            loss = tp.tp_decode_cross_entropy(p, t, lab, name, vocab, mesh)
        else:
            loss = masked_cross_entropy(elm_decode_segment(p, t, name)[..., :vocab], lab,
                                        mesh=mesh)
        losses[f"{name}_loss"] = loss
        total = total + loss
    losses["loss"] = total
    return total, losses


def classification_logits(params: dict, cfg: ProtSTonKGsConfig, batch: dict, *,
                          deterministic: bool = True,
                          rng: Optional[DropoutRng] = None,
                          **kw) -> torch.Tensor:
    """Sequence-classification forward (``stonkgs_tpu/models/
    protstonkgs.py:288-307``); ``kw`` goes to :func:`trunk_forward`.

    Evaluation runs the trunk's last layer at [CLS] alone; training runs
    the whole trunk (by default with the seeded training plan of its
    block-sparse layers), then the classifier's dropout at the trunk's
    hidden dropout rate."""
    kw.setdefault("cls_only", deterministic)
    _, pooled = trunk_forward(params, cfg, batch["input_ids"], batch.get("attention_mask"),
                              deterministic=deterministic, rng=rng, **kw)
    return classifier_head(params["classifier"], pooled,
                           dropout_prob=cfg.trunk.hidden_dropout_prob, rng=rng,
                           deterministic=deterministic)


def classification_loss(params: dict, cfg: ProtSTonKGsConfig, batch: dict,
                        **kw) -> Tuple[torch.Tensor, dict]:
    """Cross entropy and accuracy of :func:`classification_logits`
    against ``batch["labels"]``: (loss, {"loss", "accuracy"})."""
    return stonkgs.classification_metrics(
        classification_logits(params, cfg, batch, **kw), batch["labels"],
        mesh=kw.get("tp_mesh"))
