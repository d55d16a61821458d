"""HuggingFace/PyTorch checkpoint loading into the port's parameters.

The port's counterpart of the JAX package's ``utils/hf_loader.py``.  A
checkpoint directory (``config.json`` + ``pytorch_model.bin`` or
``model.safetensors``), as the published STonKGs models and
:mod:`~stonkgs_tpu_torch.utils.hf_export` write it, becomes the port's
parameter tree directly: fp32 CPU tensors, dense kernels ``(in, out)``
and contiguous, a BERT's or BigBird's layers a list of per-layer dicts
(the layout of :func:`~stonkgs_tpu_torch.utils.convert.
bert_params_from_jax`).

The state dict holds the trunk under ``bert.``, the frozen BioBERT under
``lm_backbone.`` (ProtSTonKGs: also ProtBERT under ``prot_backbone.`` and
the projection ``prot_to_lm_hidden_linear``) and the heads under
``cls.``.  The KG table is not in it: it is rebuilt from the node2vec
vectors at load time (``models/stonkgs.py::build_kg_table``), as the
reference does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from stonkgs_tpu_torch.config import BertConfig, BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig


def _tensor(x: torch.Tensor) -> torch.Tensor:
    """Floating tensors fp32, every tensor contiguous on the CPU."""
    x = x.detach().cpu()
    if x.is_floating_point():
        x = x.float()
    return x.contiguous()


def load_state_dict(model_dir_or_file: str) -> Dict[str, torch.Tensor]:
    """Load an HF checkpoint's state dict as fp32 CPU tensors.

    Accepts a directory holding ``model.safetensors`` or
    ``pytorch_model.bin`` (in that order of preference), or the file."""
    path = str(model_dir_or_file)
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no checkpoint file in {model_dir_or_file}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file   # only for this format

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _tensor(v) for k, v in sd.items()}


def load_config(model_dir: str) -> dict:
    """Read a checkpoint directory's ``config.json``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def infer_kg_vocab_size(sd: Mapping) -> int:
    """kg_vocab_size from the entity decoder's shape (rows = KG vocabulary)."""
    return int(sd["cls.predictions.entity_decoder.weight"].shape[0])


# ---------------------------------------------------------------------------
# state dict -> the port's parameter tree
# ---------------------------------------------------------------------------

def _dense(sd: Mapping, key: str) -> dict:
    p = {"kernel": sd[key + ".weight"].T.contiguous()}
    if key + ".bias" in sd:
        p["bias"] = sd[key + ".bias"]
    return p


def _ln(sd: Mapping, key: str) -> dict:
    return {"scale": sd[key + ".weight"], "bias": sd[key + ".bias"]}


def _encoder(sd: Mapping, n_layers: int, prefix: str) -> dict:
    """Embeddings and layers, shared by BERT and BigBird (the same keys)."""
    g = lambda k: prefix + k  # noqa: E731
    params = {
        "embeddings": {
            "word_embeddings": sd[g("embeddings.word_embeddings.weight")],
            "position_embeddings": sd[g("embeddings.position_embeddings.weight")],
            "token_type_embeddings": sd[g("embeddings.token_type_embeddings.weight")],
            "layer_norm": _ln(sd, g("embeddings.LayerNorm")),
        },
        "encoder": [],
    }
    for i in range(n_layers):
        lp = g(f"encoder.layer.{i}.")
        params["encoder"].append({
            "attention": {
                "query": _dense(sd, lp + "attention.self.query"),
                "key": _dense(sd, lp + "attention.self.key"),
                "value": _dense(sd, lp + "attention.self.value"),
                "output": _dense(sd, lp + "attention.output.dense"),
                "output_layer_norm": _ln(sd, lp + "attention.output.LayerNorm"),
            },
            "intermediate": _dense(sd, lp + "intermediate.dense"),
            "output": _dense(sd, lp + "output.dense"),
            "output_layer_norm": _ln(sd, lp + "output.LayerNorm"),
        })
    return params


def bert_params_from_state_dict(sd: Mapping, cfg: BertConfig, prefix: str = "") -> dict:
    """An HF ``BertModel`` state dict subtree -> one BERT tree of the port."""
    params = _encoder(sd, cfg.num_hidden_layers, prefix)
    if prefix + "pooler.dense.weight" in sd:
        params["pooler"] = _dense(sd, prefix + "pooler.dense")
    return params


def bigbird_params_from_state_dict(sd: Mapping, cfg: BigBirdConfig, prefix: str = "") -> dict:
    """An HF ``BigBirdModel`` state dict subtree -> one BigBird tree of the
    port (BERT's layout; the pooler is a bare linear, ``pooler.weight``)."""
    params = _encoder(sd, cfg.num_hidden_layers, prefix)
    if prefix + "pooler.weight" in sd:
        params["pooler"] = _dense(sd, prefix + "pooler")
    return params


def elm_head_params_from_state_dict(
    sd: Mapping, prefix: str = "cls.predictions.",
    segment_names=("text", "entity"),
) -> dict:
    """ELM head: the shared transform, one decoder per segment and its
    (never applied) bias, zeros where the checkpoint has none."""
    g = lambda k: prefix + k  # noqa: E731
    p = {
        "transform": {
            "dense": _dense(sd, g("transform.dense")),
            "layer_norm": _ln(sd, g("transform.LayerNorm")),
        }
    }
    for name in segment_names:
        p[f"{name}_decoder"] = {"kernel": sd[g(f"{name}_decoder.weight")].T.contiguous()}
        bias_key = g(f"{name}_bias")
        p[f"{name}_bias"] = (sd[bias_key] if bias_key in sd
                             else torch.zeros(p[f"{name}_decoder"]["kernel"].shape[1]))
    return p


def stonkgs_params_from_state_dict(
    sd: Mapping, cfg: STonKGsConfig, *, kg_table: Optional[torch.Tensor] = None,
) -> dict:
    """A STonKGs(ForPreTraining|ForSequenceClassification) state dict ->
    the port's STonKGs tree; ``classifier`` where the checkpoint has one
    (fine-tuned models), ``kg_backbone`` where ``kg_table`` is given."""
    params = {
        "trunk": bert_params_from_state_dict(sd, cfg.bert, "bert."),
        "lm_backbone": bert_params_from_state_dict(sd, cfg.bert, "lm_backbone."),
        "cls": {
            "predictions": elm_head_params_from_state_dict(sd),
            "seq_relationship": _dense(sd, "cls.seq_relationship"),
        },
    }
    if kg_table is not None:
        params["kg_backbone"] = kg_table
    if "classifier.weight" in sd:
        params["classifier"] = _dense(sd, "classifier")
    return params


def protstonkgs_params_from_state_dict(
    sd: Mapping, cfg: ProtSTonKGsConfig, *, kg_table: Optional[torch.Tensor] = None,
) -> dict:
    """A ProtSTonKGs state dict -> the port's ProtSTonKGs tree: BigBird
    trunk, both backbones, the protein projection and the three-segment
    head; ``classifier`` and ``kg_backbone`` as for STonKGs."""
    params = {
        "trunk": bigbird_params_from_state_dict(sd, cfg.trunk, "bert."),
        "lm_backbone": bert_params_from_state_dict(sd, cfg.lm, "lm_backbone."),
        "prot_backbone": bert_params_from_state_dict(sd, cfg.prot, "prot_backbone."),
        "prot_projection": _dense(sd, "prot_to_lm_hidden_linear"),
        "cls": {
            "predictions": elm_head_params_from_state_dict(
                sd, segment_names=("text", "entity", "prot")),
        },
    }
    if kg_table is not None:
        params["kg_backbone"] = kg_table
    if "classifier.weight" in sd:
        params["classifier"] = _dense(sd, "classifier")
    return params


def _backbone_config(sd: Mapping, prefix: str, vocab_size: int) -> BertConfig:
    """A frozen backbone's BertConfig from its weights' shapes (64-wide
    heads, as BioBERT and ProtBERT have)."""
    hidden = int(sd[prefix + "embeddings.word_embeddings.weight"].shape[1])
    return BertConfig(
        vocab_size=vocab_size,
        hidden_size=hidden,
        num_hidden_layers=max(int(k.split(".")[3]) + 1 for k in sd
                              if k.startswith(prefix + "encoder.layer.")),
        num_attention_heads=max(hidden // 64, 1),
        intermediate_size=int(sd[prefix + "encoder.layer.0.intermediate.dense.weight"].shape[0]),
        max_position_embeddings=int(
            sd[prefix + "embeddings.position_embeddings.weight"].shape[0]),
    )


def protstonkgs_config(sd: Mapping, hf_cfg: dict, *, sep_id: int = 66,
                       mask_id: int = 67, unk_id: int = 100) -> ProtSTonKGsConfig:
    """The ProtSTonKGsConfig of a checkpoint: the trunk from its
    ``config.json``, both backbones and the decoders' vocabularies from
    the weights' shapes, the special ids of the BigBird tokenizer."""
    lm_vocab = int(sd["cls.predictions.text_decoder.weight"].shape[0])
    prot_vocab = int(sd["cls.predictions.prot_decoder.weight"].shape[0])
    return ProtSTonKGsConfig(
        trunk=BigBirdConfig.from_hf_dict(hf_cfg),
        lm=_backbone_config(sd, "lm_backbone.", lm_vocab),
        prot=_backbone_config(sd, "prot_backbone.", prot_vocab),
        lm_vocab_size=lm_vocab, kg_vocab_size=infer_kg_vocab_size(sd),
        prot_vocab_size=prot_vocab,
        sep_id=sep_id, mask_id=mask_id, unk_id=unk_id,
        num_labels=hf_cfg.get("num_labels"),
    )


def load_protstonkgs_pretrained(
    model_dir: str,
    kg_embedding_path: str,
    kg_random_walk_path: str,
    *,
    sep_id: int = 66,    # BigBird tokenizer special ids
    mask_id: int = 67,
    unk_id: int = 100,
) -> Tuple[ProtSTonKGsConfig, dict]:
    """A ProtSTonKGs checkpoint + node2vec artifacts -> (cfg, params) on
    the CPU, the KG table included."""
    from stonkgs_tpu_torch.data.artifacts import load_kg_artifacts
    from stonkgs_tpu_torch.models import protstonkgs

    sd = load_state_dict(model_dir)
    cfg = protstonkgs_config(sd, load_config(model_dir), sep_id=sep_id,
                             mask_id=mask_id, unk_id=unk_id)
    params = protstonkgs_params_from_state_dict(sd, cfg)
    artifacts = load_kg_artifacts(kg_embedding_path, kg_random_walk_path)
    params["kg_backbone"] = protstonkgs.build_kg_table(
        params["lm_backbone"], cfg, artifacts.vectors)
    return cfg, params
