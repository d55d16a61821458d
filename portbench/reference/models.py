"""The reference forward passes, float32: BERT, BigBird, STonKGs and
ProtSTonKGs, from the published descriptions.

* BERT (HF ``BertModel``): word + position + token-type embeddings,
  LayerNorm, dropout; post-LN layers; masked keys take -1e9; the pooler is
  tanh(dense) of the first position.
* STonKGs: the text half through the frozen LM backbone WITHOUT an
  attention mask (as the published model runs it), the entity half a
  lookup in the KG table, whose rows at the tokenizer's special ids hold
  the backbone's output for that single token; the trunk is a BERT over
  both halves with the mask.
* ProtSTonKGs: the 768 text positions as three 256-position chunks through
  the LM backbone, the KG lookup, the protein through ProtBERT (no mask)
  and a trainable projection; the trunk is BigBird with block-sparse
  attention (HF ``BigBirdBlockSparseAttention``): the first and last
  query blocks attend every key, every other query block i its slots
  [block 0 | i-1, i, i+1 | last | r random blocks], the window's copy of
  a global block masked for blocks 1 and nb-2, masked keys -10000, the
  context times the query mask; its embeddings drop out before the
  LayerNorm.  In inference HF's random plan is all zeros (every random
  slot is block 0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference.nn import (
    NEG_INF,
    Dropout,
    Numerics,
    attention,
    dense,
    layer_norm,
    post_ln_layer,
)

BIGBIRD_PENALTY = -10000.0


def bert(p, cfg: dict, num: Numerics, *, ids=None, embeds=None, mask=None,
         token_type=None, drop: Optional[Dropout] = None):
    """(sequence output (B, S, H), pooled (B, H) or None)."""
    e = p["embeddings"]
    x = e["word_embeddings"][ids] if embeds is None else embeds
    B, S, _ = x.shape
    pos = e["position_embeddings"][torch.arange(S, device=x.device)][None]
    tt = torch.zeros((B, S), dtype=torch.int64, device=x.device) if token_type is None \
        else token_type
    x = num.store(layer_norm(x + pos + e["token_type_embeddings"][tt], e["layer_norm"],
                             cfg["layer_norm_eps"]))
    if drop is not None:
        x = drop.hidden(x, cfg["hidden_dropout_prob"])
    bias = None if mask is None else ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    rate = cfg["attention_probs_dropout_prob"]
    for lp in p["encoder"]:
        x = post_ln_layer(x, lp, cfg, lambda q, k, v: attention(q, k, v, bias, num, drop, rate),
                          num, drop)
    pooled = torch.tanh(dense(x[:, 0], p["pooler"], num)) if "pooler" in p else None
    return x, pooled


def kg_table(lm, lm_cfg: dict, vectors: torch.Tensor, special_ids, num: Numerics):
    """(N + 3, H) table: entity k at the k-th row that is no special id,
    each special id's row the LM backbone's output for that one token."""
    n, h = vectors.shape
    rows = np.setdiff1d(np.arange(n + len(special_ids)), np.asarray(special_ids))
    table = torch.zeros(n + len(special_ids), h, device=vectors.device)
    table[torch.as_tensor(rows, device=vectors.device)] = vectors.float()
    ids = torch.tensor([[s] for s in special_ids], device=vectors.device)
    seq, _ = bert(lm, lm_cfg, num, ids=ids)
    table[list(special_ids)] = seq[:, 0]
    return table


def stonkgs_trunk(w, cfg: dict, table, ids, mask, token_type, num: Numerics,
                  drop: Optional[Dropout] = None):
    """STonKGs backbones + trunk: (sequence output, pooled)."""
    tl = cfg["text_len"]
    with torch.no_grad():
        text, _ = bert(w["lm_backbone"], cfg["bert"], num, ids=ids[:, :tl], drop=drop)
        embeds = torch.cat([text, table[ids[:, tl:]]], dim=1)
    return bert(w["trunk"], cfg["bert"], num, embeds=embeds, mask=mask,
                token_type=token_type, drop=drop)


# ---------------------------------------------------------------------------
# BigBird
# ---------------------------------------------------------------------------

def block_sparse(q, k, v, mask, plan, bs: int, num: Numerics):
    """(B, S, H, D) block-sparse attention; ``plan`` (H, nb-2, r) random
    key blocks of the query blocks 1 .. nb-2."""
    B, S, H, D = q.shape
    nb = S // bs
    scale = 1.0 / np.sqrt(D)
    mask = mask.float()
    qb, kb, vb = (t.reshape(B, nb, bs, H, D).permute(0, 3, 1, 2, 4) for t in (q, k, v))
    mb = mask.reshape(B, nb, bs)
    out = torch.empty_like(qb)
    full_pen = ((1.0 - mask) * BIGBIRD_PENALTY)[:, None, None, :]
    for i in (0, nb - 1):       # global query blocks: every key
        s = num.einsum("bhqd,bhkd->bhqk", qb[:, :, i], k.permute(0, 2, 1, 3)) * scale
        pr = torch.softmax(s + full_pen, dim=-1)
        out[:, :, i] = num.einsum("bhqk,bhkd->bhqd", pr, v.permute(0, 2, 1, 3))
    n_mid = nb - 2
    j = torch.arange(n_mid, device=q.device)
    fixed = torch.stack([torch.zeros_like(j), j, j + 1, j + 2,
                         torch.full_like(j, nb - 1)], -1)                 # (n, 5)
    slots = torch.cat([fixed.expand(H, n_mid, 5),
                       torch.as_tensor(plan, device=q.device).long()], -1)  # (H, n, W)
    hix = torch.arange(H, device=q.device)[:, None, None]
    kc = kb[:, hix, slots].reshape(B, H, n_mid, -1, D)
    vc = vb[:, hix, slots].reshape(B, H, n_mid, -1, D)
    keep = mb[:, slots].clone()                                          # (B, H, n, W, bs)
    keep[:, :, 0, 1] = 0.0              # block 1's window copy of block 0
    keep[:, :, n_mid - 1, 3] = 0.0      # block nb-2's window copy of the last block
    pen = ((1.0 - keep) * BIGBIRD_PENALTY).reshape(B, H, n_mid, 1, -1)
    s = num.einsum("bhjqd,bhjkd->bhjqk", qb[:, :, 1:-1], kc) * scale + pen
    out[:, :, 1:-1] = num.einsum("bhjqk,bhjkd->bhjqd", torch.softmax(s, dim=-1), vc)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, S, H, D)
    return out * mask[:, :, None, None]


def bigbird(p, cfg: dict, embeds, mask, plan, num: Numerics):
    """BigBird encoder in inference over ``embeds``: (sequence, pooled)."""
    e = p["embeddings"]
    B, S, _ = embeds.shape
    x = embeds + e["token_type_embeddings"][0] \
        + e["position_embeddings"][torch.arange(S, device=embeds.device)][None]
    x = layer_norm(x, e["layer_norm"], cfg["layer_norm_eps"])
    bs = cfg["block_size"]
    sparse = cfg["attention_type"] == "block_sparse" and \
        S > (5 + 2 * cfg["num_random_blocks"]) * bs
    bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    for li, lp in enumerate(p["encoder"]):
        if sparse:
            fn = lambda q, k, v, li=li: block_sparse(q, k, v, mask, plan[li], bs, num)  # noqa: E731
        else:
            fn = lambda q, k, v: attention(q, k, v, bias, num)  # noqa: E731
        x = post_ln_layer(x, lp, cfg, fn, num, None)
    return x, torch.tanh(dense(x[:, 0], p["pooler"], num))


def inference_plan(cfg: dict, S: int) -> np.ndarray:
    """HF's random plan in inference: (L, H, nb-2, r), all zeros."""
    nb = S // cfg["block_size"]
    return np.zeros((cfg["num_hidden_layers"], cfg["num_attention_heads"], nb - 2,
                     cfg["num_random_blocks"]), np.int64)


def protstonkgs_pooled(w, cfg: dict, table, ids, mask, num: Numerics):
    """ProtSTonKGs pooled [CLS] output in inference."""
    kg0, pr0 = cfg["kg_start_idx"], cfg["prot_start_idx"]
    B = ids.shape[0]
    chunk = kg0 // 3
    text, _ = bert(w["lm_backbone"], cfg["lm"], num, ids=ids[:, :kg0].reshape(B * 3, chunk))
    prot, _ = bert(w["prot_backbone"], cfg["prot"], num, ids=ids[:, pr0:])
    embeds = torch.cat([text.reshape(B, kg0, -1), table[ids[:, kg0:pr0]],
                        dense(prot, w["prot_projection"], num)], dim=1)
    plan = inference_plan(cfg["trunk"], ids.shape[1])
    return bigbird(w["trunk"], cfg["trunk"], embeds, mask, plan, num)[1]
