"""ProtSTonKGs inference engine of the port: embed / classify on the card.

The port of ``ProtSTonKGsEngine`` from the JAX package's
``stonkgs_tpu/api/prot_inference.py``, built from a config plus
parameters: pooled [CLS] embeddings with the trunk's last layer at [CLS]
alone (``cls_only``) and the eval (all-zero) random plan, and
classification logits.  Every batch is dispatched before any is fetched.
:meth:`ProtSTonKGsEngine.from_pretrained` loads an HF-format checkpoint,
the node2vec artifacts and the two vocabularies (BioBERT's, ProtBERT's),
and :meth:`~ProtSTonKGsEngine.preprocess` turns rows into features.

The engine runs on the card (``device="cuda"``) unless the caller asks
for the CPU, as the tests do; with no CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from stonkgs_tpu_torch.config import ProtSTonKGsConfig
from stonkgs_tpu_torch.data.artifacts import KGArtifacts, load_kg_artifacts
from stonkgs_tpu_torch.data.fast_tokenizer import FastBertTokenizer
from stonkgs_tpu_torch.data.prot import preprocess_prot_for_pretraining
from stonkgs_tpu_torch.models import protstonkgs
from stonkgs_tpu_torch.utils import hf_loader
from stonkgs_tpu_torch.utils.batching import iter_padded_batches
from stonkgs_tpu_torch.utils.convert import params_to

BATCH_KEYS = ("input_ids", "attention_mask")


@dataclasses.dataclass
class ProtSTonKGsEngine:
    """ProtSTonKGs model + parameters on a device, serving pooled
    embeddings and classification logits over (text, KG, protein)
    features.  ``fast_trunk`` runs the trunk with dense attention, valid
    only for a model trained with it."""

    cfg: ProtSTonKGsConfig
    params: dict
    device: str = "cuda"
    compute_dtype: str = "bfloat16"
    batch_size: int = 8
    fast_trunk: bool = False
    # what preprocess needs: the text and protein tokenizers, the KG artifacts
    lm_tokenizer: Optional[object] = None
    prot_tokenizer: Optional[object] = None
    artifacts: Optional[KGArtifacts] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ProtSTonKGsEngine: no CUDA device; pass device='cpu' to run the "
                "plain path on the CPU")
        self.params = params_to(self.params, self.device)
        self._dtype = getattr(torch, self.compute_dtype)
        self._trunk_type = "original_full" if self.fast_trunk else None

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        kg_embedding_path: str,
        kg_random_walk_path: str,
        lm_vocab_file: Optional[str] = None,
        prot_vocab_file: Optional[str] = None,
        *,
        sep_id: int = 66,
        mask_id: int = 67,
        unk_id: int = 100,
        **kw,
    ) -> "ProtSTonKGsEngine":
        """Load an HF-format ProtSTonKGs checkpoint, the node2vec artifacts
        (read once) and the vocabularies; ``sep_id``/``mask_id``/``unk_id``
        are the BigBird tokenizer's, ``kw`` the engine's fields.  The KG
        table is built on the engine's device."""
        sd = hf_loader.load_state_dict(model_dir)
        cfg = hf_loader.protstonkgs_config(sd, hf_loader.load_config(model_dir),
                                           sep_id=sep_id, mask_id=mask_id, unk_id=unk_id)
        params = hf_loader.protstonkgs_params_from_state_dict(sd, cfg)
        del sd
        artifacts = load_kg_artifacts(kg_embedding_path, kg_random_walk_path)
        engine = cls(
            cfg=cfg, params=params,
            lm_tokenizer=FastBertTokenizer(lm_vocab_file) if lm_vocab_file else None,
            prot_tokenizer=(FastBertTokenizer(prot_vocab_file, do_lower_case=False)
                            if prot_vocab_file else None),
            artifacts=artifacts, **kw)
        engine.params["kg_backbone"] = protstonkgs.build_kg_table(
            engine.params["lm_backbone"], cfg, artifacts.vectors)
        return engine

    def preprocess(self, rows: Dict[str, Sequence]) -> Dict[str, np.ndarray]:
        """Rows (source, target, evidence, source_description,
        target_description, source_prot, target_prot) -> model features,
        unmasked."""
        if self.lm_tokenizer is None or self.prot_tokenizer is None or self.artifacts is None:
            raise ValueError("preprocess needs both tokenizers and the artifacts "
                             "(from_pretrained with both vocab files)")
        feats = preprocess_prot_for_pretraining(
            rows, self.artifacts, self.lm_tokenizer, self.prot_tokenizer,
            text_seq_length=self.cfg.text_len,
            prot_seq_length=self.cfg.prot_len,
            bigbird_sep_id=self.cfg.sep_id, bigbird_mask_id=self.cfg.mask_id,
            bigbird_unk_id=self.cfg.unk_id,
            apply_masking=False,
        )
        return {k: feats[k] for k in BATCH_KEYS}

    def _pooled(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return protstonkgs.trunk_forward(
            self.params, self.cfg, batch["input_ids"], batch.get("attention_mask"),
            compute_dtype=self._dtype, trunk_attention_type=self._trunk_type,
            cls_only=True)[1]

    def _classify(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return protstonkgs.classification_logits(
            self.params, self.cfg, batch, compute_dtype=self._dtype,
            trunk_attention_type=self._trunk_type)

    @torch.inference_mode()
    def _run(self, features: Dict[str, np.ndarray], fn, width: int) -> np.ndarray:
        """Dispatch every padded batch, then copy the outputs to the host."""
        n = len(features["input_ids"])
        pending = [(fn(piece), valid) for piece, valid in iter_padded_batches(
            features, BATCH_KEYS, self.batch_size, self.device)]
        out = np.zeros((n, width), np.float32)
        off = 0
        for dev, valid in pending:
            out[off: off + valid] = dev[:valid].float().cpu().numpy()
            off += valid
        return out

    def embed(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        """Pooled [CLS] embeddings, (N, hidden) float32."""
        return self._run(features, self._pooled, self.cfg.trunk.hidden_size)

    def logits(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        """Classification logits, (N, num_labels) float32."""
        if "classifier" not in self.params:
            raise ValueError("no classification head loaded")
        return self._run(features, self._classify, self.cfg.num_labels or 0)
