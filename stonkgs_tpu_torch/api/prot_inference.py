"""ProtSTonKGs inference engine of the port: embed / classify on the card.

The port of ``ProtSTonKGsEngine`` from the JAX package's
``stonkgs_tpu/api/prot_inference.py``, built from a config plus
parameters: pooled [CLS] embeddings with the trunk's last layer at [CLS]
alone (``cls_only``) and the eval (all-zero) random plan, and
classification logits.  Every batch is dispatched before any is fetched.
Loading a checkpoint (``from_pretrained``) and tokenising (``preprocess``)
need the HF checkpoint, vocabulary and node2vec files and are not ported.

The engine runs on the card (``device="cuda"``) unless the caller asks
for the CPU, as the tests do; with no CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from stonkgs_tpu_torch.config import ProtSTonKGsConfig
from stonkgs_tpu_torch.models import protstonkgs
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

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ProtSTonKGsEngine: no CUDA device; pass device='cpu' to run the "
                "plain path on the CPU")
        self.params = params_to(self.params, self.device)
        self._dtype = getattr(torch, self.compute_dtype)
        self._trunk_type = "original_full" if self.fast_trunk else None

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
