"""A configuration file as the program's config objects, and the weights
of a run, made on the device from the seed.

The weights are one tree, handed to the program and (made again from the
same seed) to the reference: dense kernels ``(in, out)``, word, position
and token-type tables, every bias and every LayerNorm offset drawn normal
with the configuration's ``initializer_range``, and LayerNorm scales 1
plus such a draw (a kernel that drops a bias, a scale or an offset
changes its output).  All leaves are views
of one buffer filled by one generator call, so making them costs
milliseconds.  The KG vectors (the
node2vec table's entity rows) are drawn the same way; each side builds
its KG table from them itself.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_ALIGN = 64  # elements: every leaf starts 256-byte aligned


def _bert_cfg(d: dict):
    from stonkgs_tpu_torch.config import BertConfig
    return BertConfig.from_hf_dict(d)


def program_config(cfg: dict):
    """The program's config object of a configuration file."""
    from stonkgs_tpu_torch.config import BigBirdConfig, ProtSTonKGsConfig, STonKGsConfig
    if cfg["model"] == "stonkgs":
        return STonKGsConfig(bert=_bert_cfg(cfg["bert"]), kg_vocab_size=cfg["kg_vocab_size"],
                             text_len=cfg["text_len"], entity_len=cfg["entity_len"],
                             sep_id=cfg["special_ids"][0], mask_id=cfg["special_ids"][1],
                             unk_id=cfg["special_ids"][2])
    if cfg["model"] == "protstonkgs":
        return ProtSTonKGsConfig(
            trunk=BigBirdConfig.from_hf_dict(cfg["trunk"]), lm=_bert_cfg(cfg["lm"]),
            prot=_bert_cfg(cfg["prot"]), kg_vocab_size=cfg["kg_vocab_size"],
            kg_start_idx=cfg["kg_start_idx"], prot_start_idx=cfg["prot_start_idx"],
            seq_len=cfg["seq_len"], sep_id=cfg["sep_id"], mask_id=cfg["mask_id"],
            unk_id=cfg["unk_id"])
    raise ValueError(f"unknown model {cfg['model']!r}")


def special_ids(cfg: dict) -> Tuple[int, int, int]:
    """The KG table's special rows (sep, mask, unk)."""
    if cfg["model"] == "stonkgs":
        return tuple(cfg["special_ids"])
    return cfg["sep_id"], cfg["mask_id"], cfg["unk_id"]


# ---------------------------------------------------------------------------
# the tree's layout: (path, shape, kind) with kind normal, or scale (1 + normal)
# ---------------------------------------------------------------------------

def _dense(path, d_in, d_out, bias=True):
    out = [(f"{path}/kernel", (d_in, d_out), "normal")]
    if bias:
        out.append((f"{path}/bias", (d_out,), "normal"))
    return out


def _ln(path, h):
    return [(f"{path}/scale", (h,), "scale"), (f"{path}/bias", (h,), "normal")]


def _encoder(path, c: dict, qkv_bias=True, pooler=True):
    h, i = c["hidden_size"], c["intermediate_size"]
    out = [(f"{path}/embeddings/word_embeddings", (c["vocab_size"], h), "normal"),
           (f"{path}/embeddings/position_embeddings", (c["max_position_embeddings"], h),
            "normal"),
           (f"{path}/embeddings/token_type_embeddings", (c["type_vocab_size"], h), "normal"),
           *_ln(f"{path}/embeddings/layer_norm", h)]
    for n in range(c["num_hidden_layers"]):
        lp = f"{path}/encoder/{n}"
        for name in ("query", "key", "value"):
            out += _dense(f"{lp}/attention/{name}", h, h, qkv_bias)
        out += _dense(f"{lp}/attention/output", h, h)
        out += _ln(f"{lp}/attention/output_layer_norm", h)
        out += _dense(f"{lp}/intermediate", h, i)
        out += _dense(f"{lp}/output", i, h)
        out += _ln(f"{lp}/output_layer_norm", h)
    if pooler:
        out += _dense(f"{path}/pooler", h, h)
    return out


def _elm_head(h, segments: List[Tuple[str, int]]):
    out = _dense("cls/predictions/transform/dense", h, h)
    out += _ln("cls/predictions/transform/layer_norm", h)
    for name, vocab in segments:
        out.append((f"cls/predictions/{name}_decoder/kernel", (h, vocab), "normal"))
        out.append((f"cls/predictions/{name}_bias", (vocab,), "normal"))
    return out


def layout(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """Every leaf but the KG table: (path, shape, kind)."""
    if cfg["model"] == "stonkgs":
        b = cfg["bert"]
        return (_encoder("trunk", b) + _encoder("lm_backbone", b)
                + _elm_head(b["hidden_size"], [("text", b["vocab_size"]),
                                                ("entity", cfg["kg_vocab_size"])])
                + _dense("cls/seq_relationship", b["hidden_size"], 2))
    t, lm, pr = cfg["trunk"], cfg["lm"], cfg["prot"]
    return (_encoder("trunk", t, qkv_bias=t["use_bias"]) + _encoder("lm_backbone", lm)
            + _encoder("prot_backbone", pr)
            + _dense("prot_projection", pr["hidden_size"], t["hidden_size"])
            + _elm_head(t["hidden_size"], [("text", lm["vocab_size"]),
                                           ("entity", cfg["kg_vocab_size"]),
                                           ("prot", pr["vocab_size"])]))


def _std(cfg: dict, path: str) -> float:
    top = path.split("/")[0]
    sub = {"trunk": "trunk", "lm_backbone": "lm", "prot_backbone": "prot"}
    if cfg["model"] == "stonkgs":
        return cfg["bert"]["initializer_range"]
    return cfg[sub.get(top, "trunk")]["initializer_range"]


def _tree(entries: Dict[str, torch.Tensor]) -> dict:
    """Nested dicts from paths; an ``encoder`` node is a list of layers."""
    root: dict = {}
    for path, t in entries.items():
        keys = path.split("/")
        node = root
        i = 0
        while i < len(keys) - 1:
            k = keys[i]
            if k == "encoder":
                layers = node.setdefault("encoder", [])
                n = int(keys[i + 1])
                while len(layers) <= n:
                    layers.append({})
                node = layers[n]
                i += 2
                continue
            node = node.setdefault(k, {})
            i += 1
        node[keys[-1]] = t
    return root


def _padded(shape) -> int:
    return -(-torch.Size(shape).numel() // _ALIGN) * _ALIGN


def make_weights(cfg: dict, seed: int, device) -> Tuple[dict, torch.Tensor]:
    """(weight tree without the KG table, KG vectors (N, H)), float32 on
    ``device``, from ``seed``: one generator, two calls."""
    entries = layout(cfg)
    hidden = cfg["bert"]["hidden_size"] if cfg["model"] == "stonkgs" \
        else cfg["trunk"]["hidden_size"]
    n_kg = cfg["kg_vocab_size"] * hidden
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(sum(_padded(s) for _, s, _ in entries), device=device).normal_(
        0.0, 1.0, generator=gen)
    vectors = torch.empty(n_kg, device=device).normal_(
        0.0, cfg.get("kg_vector_std", 1.0), generator=gen).view(-1, hidden)
    out, off = {}, 0
    for path, shape, kind in entries:
        n = torch.Size(shape).numel()
        out[path] = flat[off: off + n].view(shape).mul_(_std(cfg, path))
        if kind == "scale":
            out[path].add_(1.0)
        off += _padded(shape)
    return _tree(out), vectors


def count_params(cfg: dict) -> Dict[str, int]:
    """Parameters by top-level key (the KG table as ``kg_backbone``)."""
    out: Dict[str, int] = {}
    for path, shape, _ in layout(cfg):
        top = path.split("/")[0]
        out[top] = out.get(top, 0) + torch.Size(shape).numel()
    hidden = cfg["bert"]["hidden_size"] if cfg["model"] == "stonkgs" \
        else cfg["trunk"]["hidden_size"]
    out["kg_backbone"] = (cfg["kg_vocab_size"] + 3) * hidden
    return out
