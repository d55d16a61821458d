"""Model configurations for the PyTorch/CUDA port of STonKGs.

The port's own copy of ``BertConfig``, ``STonKGsConfig``,
``ProtSTonKGsConfig`` and ``BigBirdConfig``: the same frozen dataclasses,
field for field, as the JAX package's ``config.py``,
so a configuration written for one package means the same model in the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    @classmethod
    def from_hf_dict(cls, d: dict) -> "BertConfig":
        """Build from a HuggingFace config.json dict (unknown keys ignored)."""
        return _from_hf_dict(cls, d)

    @classmethod
    def from_json_file(cls, path: str | os.PathLike) -> "BertConfig":
        """Build from a config.json path (HF checkpoint layout)."""
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


def _from_hf_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


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


@dataclasses.dataclass(frozen=True)
class ProtSTonKGsConfig:
    """Configuration of the tri-modality ProtSTonKGs model.

    Sequence layout ``[text 768 | kg 256 | prot 3072]`` = 4096 tokens into
    a BigBird trunk; the text is embedded by a frozen BioBERT, the KG part
    by a table gather and the protein part by a frozen ProtBERT.
    """

    trunk: "BigBirdConfig" = None  # type: ignore[assignment]
    lm: BertConfig = dataclasses.field(default_factory=BertConfig)
    prot: BertConfig = dataclasses.field(
        default_factory=lambda: BertConfig(
            vocab_size=30, hidden_size=1024, num_hidden_layers=30,
            num_attention_heads=16, intermediate_size=4096,
            max_position_embeddings=40000,
        )
    )
    # decoder vocab sizes; None derives them from the backbone configs in
    # __post_init__ so the pairs cannot silently diverge
    lm_vocab_size: Optional[int] = None
    kg_vocab_size: int = 0
    prot_vocab_size: Optional[int] = None
    kg_start_idx: int = 768
    prot_start_idx: int = 1024
    seq_len: int = 4096
    # special token ids of the BigBird tokenizer: the KG table's LM rows
    unk_id: int = 100
    sep_id: int = 66
    mask_id: int = 67
    num_labels: Optional[int] = None

    def __post_init__(self):
        if self.lm_vocab_size is None:
            object.__setattr__(self, "lm_vocab_size", self.lm.vocab_size)
        if self.prot_vocab_size is None:
            object.__setattr__(self, "prot_vocab_size", self.prot.vocab_size)

    @property
    def text_len(self) -> int:
        return self.kg_start_idx

    @property
    def entity_len(self) -> int:
        return self.prot_start_idx - self.kg_start_idx

    @property
    def prot_len(self) -> int:
        return self.seq_len - self.prot_start_idx

    @property
    def kg_table_size(self) -> int:
        return self.kg_vocab_size + 3

    def replace(self, **kw) -> "ProtSTonKGsConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BigBirdConfig:
    """BigBird encoder config (``google/bigbird-roberta-base`` defaults), the
    trunk of ProtSTonKGs; attention is ``original_full`` or
    ``block_sparse``."""

    vocab_size: int = 50358
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu_new"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 4096
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    attention_type: str = "block_sparse"
    block_size: int = 64
    num_random_blocks: int = 3
    use_bias: bool = True
    rescale_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_dict(cls, d: dict) -> "BigBirdConfig":
        """Build from a HuggingFace BigBird config.json dict (unknown keys
        ignored)."""
        return _from_hf_dict(cls, d)
