"""Model configurations for the PyTorch/CUDA port of STonKGs.

The port's own copy of ``BertConfig`` and ``STonKGsConfig``: the same
frozen dataclasses, field for field, as the JAX package's ``config.py``,
so a configuration written for one package means the same model in the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Configuration of a BERT-style encoder (HF ``BertModel`` semantics).

    Defaults are BioBERT v1.1 / BERT-base, the LM backbone and trunk of
    STonKGs.
    """

    vocab_size: int = 28996
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"  # exact erf-based gelu, like HF "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class STonKGsConfig:
    """Configuration of the dual-modality STonKGs model.

    The input sequence is ``[text_len | entity_len]`` positions long; the
    text half is embedded by a frozen LM backbone, the entity half by a
    KG-table gather.  The table carries ``kg_vocab_size + 3`` rows because
    ids 100/102/103 (UNK/SEP/MASK) hold LM-derived special embeddings.
    """

    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    kg_vocab_size: int = 0
    # Sequence layout. STonKGs: 256 + 256; TransESTonKGs: 256 + 4.
    text_len: int = 256
    entity_len: int = 256
    # Special token ids of the LM tokenizer (BertTokenizer defaults).
    unk_id: int = 100
    sep_id: int = 102
    mask_id: int = 103
    num_labels: Optional[int] = None  # set for sequence classification

    @property
    def seq_len(self) -> int:
        return self.text_len + self.entity_len

    @property
    def kg_table_size(self) -> int:
        """Number of rows of the KG backbone table (entities + 3 special rows)."""
        return self.kg_vocab_size + 3

    def replace(self, **kw) -> "STonKGsConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def transe(cls, kg_vocab_size: int, **kw) -> "STonKGsConfig":
        """TransESTonKGs layout: 256 text + [h, r, t, SEP]."""
        bert = kw.pop("bert", BertConfig(max_position_embeddings=260))
        return cls(bert=bert, kg_vocab_size=kg_vocab_size, text_len=256,
                   entity_len=4, **kw)
