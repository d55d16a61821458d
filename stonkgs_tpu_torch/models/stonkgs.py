"""STonKGs, dual-modality (text + KG) BERT, in PyTorch.

The port of the JAX package's ``stonkgs_tpu/models/stonkgs.py``: parameter
init, the KG table, the frozen backbones, the trunk, the pooled output and
classification logits and loss (serving and fine-tuning), and the
pre-training logits and loss (MLM + ELM on the gathered masked positions,
plus NSP).  Quirks kept on purpose:

* the frozen LM backbone runs with NO attention mask and attends over
  PAD positions, as the reference model does;
* in training the frozen backbone runs WITH dropout, under
  ``torch.no_grad()``: the JAX package's ``stop_gradient`` after a
  training-mode backbone (``stonkgs.py:218-229``);
* the KG table's special rows (100/102/103 by default) hold the LM
  backbone's output for the length-1 sequence of each special token id;
* the ELM decoder biases exist but are never applied;
* the TransE layout (256 + 4) is the same code with another config.

Under a mesh (``tp_mesh``, a :class:`~stonkgs_tpu_torch.parallel.mesh.Mesh`)
the KG table and the decoders hold this rank's slices: the entity half is
looked up by :func:`~stonkgs_tpu_torch.parallel.tp.tp_gather` and the MLM
and ELM losses decode through
:func:`~stonkgs_tpu_torch.parallel.tp.tp_masked_cross_entropy` when the
mesh has a model axis, and every batch mean divides by the count over its
data axis (the JAX package's ``tp_mesh``, ``stonkgs.py:155-181, 311-333``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import bert
from stonkgs_tpu_torch.models.bert import DropoutRng
from stonkgs_tpu_torch.models.heads import (
    classifier_head,
    elm_decode_segment,
    elm_head_dense,
    elm_transform,
    init_classifier_head,
    init_elm_head,
    init_nsp_head,
    nsp_head,
)
from stonkgs_tpu_torch.ops.losses import gather_masked_positions, masked_cross_entropy
from stonkgs_tpu_torch.parallel import tp
from stonkgs_tpu_torch.parallel.mesh import data_sum


def init_stonkgs_params(
    gen: torch.Generator,
    cfg: STonKGsConfig,
    *,
    with_classifier: bool = False,
) -> dict:
    """The full parameter tree, fp32 on the CPU, from ``gen``: trunk, LM
    backbone, KG table, the pre-training heads (``cls``) and, optionally,
    the classifier.

    The frozen KG backbone ((kg_vocab+3, H)) starts as zeros: fill it with
    :func:`build_kg_table`."""
    bcfg = cfg.bert
    params = {
        "trunk": bert.init_bert_params(gen, bcfg, with_pooler=True),
        "lm_backbone": bert.init_bert_params(gen, bcfg, with_pooler=True),
        "kg_backbone": torch.zeros(cfg.kg_table_size, bcfg.hidden_size),
    }
    params["cls"] = {
        "predictions": init_elm_head(gen, bcfg, [bcfg.vocab_size, cfg.kg_vocab_size],
                                     ("text", "entity")),
        "seq_relationship": init_nsp_head(gen, bcfg),
    }
    if with_classifier:
        if cfg.num_labels is None:
            raise ValueError("with_classifier needs cfg.num_labels")
        params["classifier"] = init_classifier_head(gen, bcfg, cfg.num_labels)
    return params


# sep, mask, unk of the BERT tokenizer: STonKGs' LM-derived KG table rows
SPECIAL_IDS = (102, 103, 100)


def kg_row_permutation(n_entities: int, special_ids=SPECIAL_IDS) -> np.ndarray:
    """Row index in the KG table for each entity index 0..N-1: entity k sits
    at row k shifted past every special id at or below it."""
    rows = np.setdiff1d(np.arange(n_entities + len(special_ids)),
                        np.asarray(special_ids))
    assert rows.shape[0] == n_entities
    return rows


def build_kg_table(
    lm_params: dict,
    bert_cfg: BertConfig,
    kg_vectors: np.ndarray,       # (N, H) node2vec vectors in key order
    *,
    compute_dtype: torch.dtype = torch.float32,
    special_ids=SPECIAL_IDS,
) -> torch.Tensor:
    """Build the (N+3, H) fp32 KG backbone table on the LM params' device.

    Special rows, at ``special_ids`` (STonKGs' BERT sep/mask/unk by
    default), hold the LM backbone's hidden state for the length-1
    sequence ``[special_id]``."""
    n, h = kg_vectors.shape
    if h != bert_cfg.hidden_size:
        raise ValueError(f"KG embedding dim {h} != model hidden size "
                         f"{bert_cfg.hidden_size}")
    if max(special_ids) >= bert_cfg.vocab_size:
        raise ValueError(f"special token ids {tuple(special_ids)} exceed LM vocab "
                         f"{bert_cfg.vocab_size}")
    device = lm_params["embeddings"]["word_embeddings"].device
    table = np.zeros((n + len(special_ids), h), np.float32)
    table[kg_row_permutation(n, special_ids)] = np.asarray(kg_vectors, np.float32)
    ids = torch.tensor([[s] for s in special_ids], device=device)  # (3, 1)
    seq, _ = bert.bert_model(lm_params, bert_cfg, input_ids=ids,
                             compute_dtype=compute_dtype, with_pooler=False)
    table = torch.from_numpy(table).to(device)
    table[list(special_ids)] = seq[:, 0, :].float()
    return table


def backbone_embeddings(
    params: dict,
    cfg: STonKGsConfig,
    input_ids: torch.Tensor,      # (B, text_len + entity_len)
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    tp_mesh=None,
) -> torch.Tensor:
    """Frozen-backbone input embeddings for the trunk: (B, S, H).

    Text half -> frozen LM backbone (NO attention mask); entity half -> KG
    table gather, row-split over ``tp_mesh``'s model axis where it has one."""
    text_ids = input_ids[:, : cfg.text_len]
    ent_ids = input_ids[:, cfg.text_len:]
    token_embeddings, _ = bert.bert_model(
        params["lm_backbone"], cfg.bert, input_ids=text_ids,
        attention_mask=None, deterministic=deterministic, rng=rng,
        compute_dtype=compute_dtype, with_pooler=False,
    )
    table = params["kg_backbone"].to(compute_dtype)
    if tp.has_model_axis(tp_mesh):
        ent_embeddings = tp.tp_gather(table, ent_ids, tp_mesh)
    else:
        ent_embeddings = table[ent_ids]
    return torch.cat([token_embeddings, ent_embeddings], dim=1)


def trunk_forward(
    params: dict,
    cfg: STonKGsConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    rng: Optional[DropoutRng] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat=False,
    cls_only: bool = False,
    position_ids: Optional[torch.Tensor] = None,
    tp_mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbones + trunk. Returns (sequence_output, pooled_output).

    The frozen backbones run under ``torch.no_grad()`` (in training with
    their dropout, as the JAX package's ``stop_gradient`` after them), so
    no gradient reaches them and their layers launch forward kernels only.

    ``position_ids`` apply to the TRUNK only (the backbone always embeds its
    text at positions 0..text_len-1): the length-bucketed mode passes
    ``[0..Sb-1, text_len..]`` so a truncated text half keeps the entity
    half on its original position rows."""
    with torch.no_grad():
        inputs_embeds = backbone_embeddings(
            params, cfg, input_ids, deterministic=deterministic, rng=rng,
            compute_dtype=compute_dtype, tp_mesh=tp_mesh)
    return bert.bert_model(
        params["trunk"], cfg.bert,
        inputs_embeds=inputs_embeds,
        attention_mask=attention_mask,
        token_type_ids=token_type_ids,
        position_ids=position_ids,
        deterministic=deterministic, rng=rng,
        compute_dtype=compute_dtype, remat=remat, with_pooler=True, cls_only=cls_only,
    )


def pooler_output(params: dict, cfg: STonKGsConfig, batch: dict, *,
                  compute_dtype: torch.dtype = torch.float32,
                  tp_mesh=None) -> torch.Tensor:
    """Embedding-extraction path: the pooled [CLS] output only.  The trunk's
    last layer runs only at the [CLS] position (``cls_only``)."""
    _, pooled = trunk_forward(
        params, cfg, batch["input_ids"], batch.get("attention_mask"),
        batch.get("token_type_ids"), compute_dtype=compute_dtype,
        cls_only=True, position_ids=batch.get("position_ids"), tp_mesh=tp_mesh,
    )
    return pooled


def classification_logits(params: dict, cfg: STonKGsConfig, batch: dict, *,
                          deterministic: bool = True,
                          rng: Optional[DropoutRng] = None,
                          **kw) -> torch.Tensor:
    """Sequence-classification forward (``stonkgs_tpu/models/stonkgs.py:
    371-398``); ``kw`` goes to :func:`trunk_forward`.

    Evaluation runs the trunk's last layer at [CLS] alone (``cls_only``);
    training (``deterministic=False`` with the step's :class:`DropoutRng`)
    runs the whole trunk through the training kernels, then the
    classifier's dropout at the hidden dropout rate.  ``position_ids`` in
    the batch reach the trunk."""
    kw.setdefault("cls_only", deterministic)
    kw.setdefault("position_ids", batch.get("position_ids"))
    _, pooled = trunk_forward(
        params, cfg, batch["input_ids"], batch.get("attention_mask"),
        batch.get("token_type_ids"), deterministic=deterministic, rng=rng, **kw)
    return classifier_head(params["classifier"], pooled,
                           dropout_prob=cfg.bert.hidden_dropout_prob, rng=rng,
                           deterministic=deterministic)


def classification_loss(params: dict, cfg: STonKGsConfig, batch: dict,
                        **kw) -> Tuple[torch.Tensor, dict]:
    """Cross entropy of :func:`classification_logits` against
    ``batch["labels"]``; returns (loss, {"loss", "accuracy"}).  ``kw`` are
    :func:`make_train_step`'s (``deterministic``, ``rng``,
    ``compute_dtype``, ``tp_mesh``) and :func:`trunk_forward`'s."""
    return classification_metrics(classification_logits(params, cfg, batch, **kw),
                                  batch["labels"], mesh=kw.get("tp_mesh"))


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor,
                           mesh=None) -> Tuple[torch.Tensor, dict]:
    """(cross entropy, {"loss", "accuracy"}) of classification logits;
    under a ``mesh`` both are this data rank's share of the global mean."""
    loss = masked_cross_entropy(logits, labels, mesh=mesh)
    hits = (logits.argmax(dim=-1) == labels).float()
    if mesh is None or mesh.n_data == 1:
        accuracy = hits.mean()
    else:
        accuracy = hits.sum() / data_sum(hits.new_tensor(float(hits.numel())), mesh)
    return loss, {"loss": loss, "accuracy": accuracy}


def pretraining_logits(
    params: dict,
    cfg: STonKGsConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-shaped outputs: (mlm_logits, elm_logits, nsp_logits, pooled)."""
    seq, pooled = trunk_forward(params, cfg, input_ids, attention_mask,
                                token_type_ids, **kw)
    mlm, elm = elm_head_dense(
        params["cls"]["predictions"], seq, cfg.bert,
        [(0, cfg.text_len), (cfg.text_len, cfg.seq_len)], ("text", "entity"))
    nsp = nsp_head(params["cls"]["seq_relationship"], pooled)
    return mlm, elm, nsp, pooled


def pretraining_loss(
    params: dict,
    cfg: STonKGsConfig,
    batch: dict,
    *,
    max_text_predictions: Optional[int] = None,
    max_entity_predictions: Optional[int] = None,
    dense_heads: bool = False,
    **kw,
) -> Tuple[torch.Tensor, dict]:
    """MLM + ELM + NSP loss, their sum (``stonkgs_tpu/models/stonkgs.py:
    285-368``); ``kw`` goes to :func:`trunk_forward`.

    With ``dense_heads=False`` only the masked positions are decoded: the
    data pipeline masks exactly ``int(0.15 * len)`` positions per half, and
    k = ``max(int(0.15 * len), 1)`` slots are gathered per half.  Returns
    (loss, {"loss", "mlm_loss", "elm_loss", "nsp_loss"}).

    Under ``tp_mesh`` (in ``kw``) with a model axis, the decoders hold this
    rank's padded columns and decode through the vocab-parallel loss."""
    mesh = kw.get("tp_mesh")
    seq, pooled = trunk_forward(
        params, cfg, batch["input_ids"], batch.get("attention_mask"),
        batch.get("token_type_ids"), **kw)
    p = params["cls"]["predictions"]
    mlm_labels = batch["masked_lm_labels"]
    elm_labels = batch["ent_masked_lm_labels"]
    tl = cfg.text_len

    def decode_loss(t, labels, name, vocab):
        if tp.has_model_axis(mesh):
            return tp.tp_decode_cross_entropy(p, t, labels, name, vocab, mesh)
        return masked_cross_entropy(elm_decode_segment(p, t, name), labels, mesh=mesh)

    if dense_heads:
        t = elm_transform(p, seq, cfg.bert)
        mlm_loss = decode_loss(t[:, :tl], mlm_labels, "text", cfg.bert.vocab_size)
        elm_loss = decode_loss(t[:, tl:], elm_labels, "entity", cfg.kg_vocab_size)
    else:
        k_text = max_text_predictions or max(int(cfg.text_len * 0.15), 1)
        k_ent = max_entity_predictions or max(int(cfg.entity_len * 0.15), 1)
        text_h, text_l, _ = gather_masked_positions(seq[:, :tl], mlm_labels, k_text)
        ent_h, ent_l, _ = gather_masked_positions(seq[:, tl:], elm_labels, k_ent)
        mlm_loss = decode_loss(elm_transform(p, text_h, cfg.bert), text_l, "text",
                               cfg.bert.vocab_size)
        elm_loss = decode_loss(elm_transform(p, ent_h, cfg.bert), ent_l, "entity",
                               cfg.kg_vocab_size)
    nsp_logits = nsp_head(params["cls"]["seq_relationship"], pooled)
    nsp_loss = masked_cross_entropy(nsp_logits, batch["next_sentence_labels"], mesh=mesh)
    loss = mlm_loss + elm_loss + nsp_loss
    return loss, {"loss": loss, "mlm_loss": mlm_loss,
                  "elm_loss": elm_loss, "nsp_loss": nsp_loss}
