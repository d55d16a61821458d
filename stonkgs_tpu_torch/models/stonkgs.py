"""STonKGs, dual-modality (text + KG) BERT, inference path in PyTorch.

The port of the JAX package's ``stonkgs_tpu/models/stonkgs.py`` for
serving: parameter init, the KG table, the frozen backbones, the trunk,
the pooled output and classification logits.  Quirks kept on purpose:

* the frozen LM backbone runs with NO attention mask and attends over
  PAD positions, as the reference model does;
* the KG table's special rows 100/102/103 hold the LM backbone's output
  for the length-1 sequence of each special token id;
* the TransE layout (256 + 4) is the same code with another config.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.models import bert
from stonkgs_tpu_torch.models.heads import classifier_head, init_classifier_head


def init_stonkgs_params(
    gen: torch.Generator,
    cfg: STonKGsConfig,
    *,
    with_classifier: bool = False,
) -> dict:
    """The serving path's parameter tree, fp32 on the CPU, from ``gen``.

    The frozen KG backbone ((kg_vocab+3, H)) starts as zeros: fill it with
    :func:`build_kg_table`."""
    bcfg = cfg.bert
    params = {
        "trunk": bert.init_bert_params(gen, bcfg, with_pooler=True),
        "lm_backbone": bert.init_bert_params(gen, bcfg, with_pooler=True),
        "kg_backbone": torch.zeros(cfg.kg_table_size, bcfg.hidden_size),
    }
    if with_classifier:
        if cfg.num_labels is None:
            raise ValueError("with_classifier needs cfg.num_labels")
        params["classifier"] = init_classifier_head(gen, bcfg, cfg.num_labels)
    return params


SPECIAL_IDS = (102, 103, 100)  # sep, mask, unk: the KG table's LM-derived rows


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
) -> torch.Tensor:
    """Build the (N+3, H) fp32 KG backbone table on the LM params' device.

    Special rows hold the LM backbone's hidden state for the length-1
    sequence ``[special_id]``."""
    n, h = kg_vectors.shape
    if h != bert_cfg.hidden_size:
        raise ValueError(f"KG embedding dim {h} != model hidden size "
                         f"{bert_cfg.hidden_size}")
    if max(SPECIAL_IDS) >= bert_cfg.vocab_size:
        raise ValueError(f"special token ids {SPECIAL_IDS} exceed LM vocab "
                         f"{bert_cfg.vocab_size}")
    device = lm_params["embeddings"]["word_embeddings"].device
    table = np.zeros((n + 3, h), np.float32)
    table[kg_row_permutation(n)] = np.asarray(kg_vectors, np.float32)
    ids = torch.tensor([[s] for s in SPECIAL_IDS], device=device)  # (3, 1)
    seq, _ = bert.bert_model(lm_params, bert_cfg, input_ids=ids,
                             compute_dtype=compute_dtype, with_pooler=False)
    table = torch.from_numpy(table).to(device)
    table[list(SPECIAL_IDS)] = seq[:, 0, :].float()
    return table


def backbone_embeddings(
    params: dict,
    cfg: STonKGsConfig,
    input_ids: torch.Tensor,      # (B, text_len + entity_len)
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Frozen-backbone input embeddings for the trunk: (B, S, H).

    Text half -> frozen LM backbone (NO attention mask); entity half -> KG
    table gather."""
    text_ids = input_ids[:, : cfg.text_len]
    ent_ids = input_ids[:, cfg.text_len:]
    token_embeddings, _ = bert.bert_model(
        params["lm_backbone"], cfg.bert, input_ids=text_ids,
        attention_mask=None, compute_dtype=compute_dtype, with_pooler=False,
    )
    ent_embeddings = params["kg_backbone"].to(compute_dtype)[ent_ids]
    return torch.cat([token_embeddings, ent_embeddings], dim=1)


def trunk_forward(
    params: dict,
    cfg: STonKGsConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    cls_only: bool = False,
    position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbones + trunk. Returns (sequence_output, pooled_output).

    ``position_ids`` apply to the TRUNK only (the backbone always embeds its
    text at positions 0..text_len-1): the length-bucketed mode passes
    ``[0..Sb-1, text_len..]`` so a truncated text half keeps the entity
    half on its original position rows."""
    bert.check_inference(deterministic)
    inputs_embeds = backbone_embeddings(params, cfg, input_ids,
                                        compute_dtype=compute_dtype)
    return bert.bert_model(
        params["trunk"], cfg.bert,
        inputs_embeds=inputs_embeds,
        attention_mask=attention_mask,
        token_type_ids=token_type_ids,
        position_ids=position_ids,
        compute_dtype=compute_dtype, with_pooler=True, cls_only=cls_only,
    )


def pooler_output(params: dict, cfg: STonKGsConfig, batch: dict, *,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Embedding-extraction path: the pooled [CLS] output only.  The trunk's
    last layer runs only at the [CLS] position (``cls_only``)."""
    _, pooled = trunk_forward(
        params, cfg, batch["input_ids"], batch.get("attention_mask"),
        batch.get("token_type_ids"), compute_dtype=compute_dtype,
        cls_only=True, position_ids=batch.get("position_ids"),
    )
    return pooled


def classification_logits(params: dict, cfg: STonKGsConfig, batch: dict, *,
                          deterministic: bool = True,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sequence-classification forward (evaluation: no dropout)."""
    bert.check_inference(deterministic)
    pooled = pooler_output(params, cfg, batch, compute_dtype=compute_dtype)
    return classifier_head(params["classifier"], pooled)
