"""Export the port's parameters as an HF/PyTorch checkpoint directory.

The port's counterpart of the JAX package's ``utils/hf_export.py`` and the
inverse of :mod:`~stonkgs_tpu_torch.utils.hf_loader`: ``pytorch_model.bin``
(``torch.save`` of fp32 CPU tensors in the reference's key layout) and
``config.json``, which the reference implementation, any HF
``from_pretrained`` and both packages' loaders read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

import torch

from stonkgs_tpu_torch.config import ProtSTonKGsConfig, STonKGsConfig


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).contiguous()


def _dense(sd: dict, key: str, p: Mapping) -> None:
    sd[key + ".weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _ln(sd: dict, key: str, p: Mapping) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def bert_state_dict(params: Mapping, prefix: str = "") -> dict:
    """One BERT tree of the port -> HF ``BertModel`` state dict."""
    sd: dict = {}
    emb = params["embeddings"]
    sd[prefix + "embeddings.word_embeddings.weight"] = _t(emb["word_embeddings"])
    sd[prefix + "embeddings.position_embeddings.weight"] = _t(emb["position_embeddings"])
    sd[prefix + "embeddings.token_type_embeddings.weight"] = _t(emb["token_type_embeddings"])
    _ln(sd, prefix + "embeddings.LayerNorm", emb["layer_norm"])
    for i, layer in enumerate(params["encoder"]):
        pre = prefix + f"encoder.layer.{i}."
        _dense(sd, pre + "attention.self.query", layer["attention"]["query"])
        _dense(sd, pre + "attention.self.key", layer["attention"]["key"])
        _dense(sd, pre + "attention.self.value", layer["attention"]["value"])
        _dense(sd, pre + "attention.output.dense", layer["attention"]["output"])
        _ln(sd, pre + "attention.output.LayerNorm",
            layer["attention"]["output_layer_norm"])
        _dense(sd, pre + "intermediate.dense", layer["intermediate"])
        _dense(sd, pre + "output.dense", layer["output"])
        _ln(sd, pre + "output.LayerNorm", layer["output_layer_norm"])
    if "pooler" in params:
        _dense(sd, prefix + "pooler.dense", params["pooler"])
    return sd


def _decoders(sd: dict, p: Mapping, vocab_sizes: Mapping[str, int]) -> None:
    """The ELM head's transform and each segment's decoder and bias, cut
    to the configured vocabulary."""
    _dense(sd, "cls.predictions.transform.dense", p["transform"]["dense"])
    _ln(sd, "cls.predictions.transform.LayerNorm", p["transform"]["layer_norm"])
    for name, v in vocab_sizes.items():
        sd[f"cls.predictions.{name}_decoder.weight"] = (
            _t(p[f"{name}_decoder"]["kernel"])[:, :v].T.contiguous())
        sd[f"cls.predictions.{name}_bias"] = _t(p[f"{name}_bias"])[:v].contiguous()


def stonkgs_state_dict(params: Mapping, cfg: STonKGsConfig) -> dict:
    """The port's STonKGs tree -> the reference's state dict.

    Includes the HF parent class's head (``decoder`` tied to the trunk's
    word embeddings, zero biases), which ``BertForPreTraining``-derived
    classes expect; the KG table is not exported."""
    sd = {}
    sd.update(bert_state_dict(params["trunk"], "bert."))
    sd.update(bert_state_dict(params["lm_backbone"], "lm_backbone."))
    _decoders(sd, params["cls"]["predictions"],
              {"text": cfg.bert.vocab_size, "entity": cfg.kg_vocab_size})
    # parent BertLMPredictionHead params (unused by forward; tied to word emb)
    sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = torch.zeros(cfg.bert.vocab_size)
    sd["cls.predictions.bias"] = torch.zeros(cfg.bert.vocab_size)
    _dense(sd, "cls.seq_relationship", params["cls"]["seq_relationship"])
    if "classifier" in params:
        _dense(sd, "classifier", params["classifier"])
    return sd


def bigbird_state_dict(params: Mapping, prefix: str = "") -> dict:
    """One BigBird tree of the port -> HF ``BigBirdModel`` state dict
    (BERT's layout; the pooler is a bare linear, ``pooler.weight``)."""
    sd = bert_state_dict(params, prefix)
    if prefix + "pooler.dense.weight" in sd:
        sd[prefix + "pooler.weight"] = sd.pop(prefix + "pooler.dense.weight")
        sd[prefix + "pooler.bias"] = sd.pop(prefix + "pooler.dense.bias")
    return sd


def protstonkgs_state_dict(params: Mapping, cfg: ProtSTonKGsConfig) -> dict:
    """The port's ProtSTonKGs tree -> the reference's state dict."""
    sd = {}
    sd.update(bigbird_state_dict(params["trunk"], "bert."))
    sd.update(bert_state_dict(params["lm_backbone"], "lm_backbone."))
    sd.update(bert_state_dict(params["prot_backbone"], "prot_backbone."))
    _dense(sd, "prot_to_lm_hidden_linear", params["prot_projection"])
    _decoders(sd, params["cls"]["predictions"],
              {"text": cfg.lm_vocab_size, "entity": cfg.kg_vocab_size,
               "prot": cfg.prot_vocab_size})
    if "classifier" in params:
        _dense(sd, "classifier", params["classifier"])
    return sd


def _write(sd: dict, config: dict, output_dir: str) -> str:
    os.makedirs(output_dir, exist_ok=True)
    torch.save(sd, os.path.join(output_dir, "pytorch_model.bin"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return output_dir


def save_protstonkgs_pretrained(params: Mapping, cfg: ProtSTonKGsConfig,
                                output_dir: str) -> str:
    """Write a ProtSTonKGs checkpoint directory."""
    config = {**dataclasses.asdict(cfg.trunk),
              "architectures": ["ProtSTonKGsForPreTraining"],
              "model_type": "big_bird",
              "lm_vocab_size": cfg.lm_vocab_size,
              "kg_vocab_size": cfg.kg_vocab_size,
              "prot_vocab_size": cfg.prot_vocab_size}
    if cfg.num_labels is not None:
        config["num_labels"] = cfg.num_labels
    return _write(protstonkgs_state_dict(params, cfg), config, output_dir)


def save_pretrained(
    params: Mapping,
    cfg: STonKGsConfig,
    output_dir: str,
    *,
    extra_config: Mapping = (),
) -> str:
    """Write a STonKGs checkpoint directory (``pytorch_model.bin`` +
    ``config.json``)."""
    b = cfg.bert
    config = {
        "architectures": ["STonKGsForPreTraining"],
        "model_type": "bert",
        "vocab_size": b.vocab_size,
        "hidden_size": b.hidden_size,
        "num_hidden_layers": b.num_hidden_layers,
        "num_attention_heads": b.num_attention_heads,
        "intermediate_size": b.intermediate_size,
        "hidden_act": b.hidden_act,
        "hidden_dropout_prob": b.hidden_dropout_prob,
        "attention_probs_dropout_prob": b.attention_probs_dropout_prob,
        "max_position_embeddings": b.max_position_embeddings,
        "type_vocab_size": b.type_vocab_size,
        "initializer_range": b.initializer_range,
        "layer_norm_eps": b.layer_norm_eps,
        "kg_vocab_size": cfg.kg_vocab_size,
        **dict(extra_config),
    }
    if cfg.num_labels is not None:
        config["num_labels"] = cfg.num_labels
    return _write(stonkgs_state_dict(params, cfg), config, output_dir)
