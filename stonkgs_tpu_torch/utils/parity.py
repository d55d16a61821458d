"""Checkpoint parity against HF ``transformers`` on the CPU.

The port of the JAX package's ``stonkgs_tpu/utils/parity.py``.  An
HF-format STonKGs checkpoint is loaded twice: by the port's
:class:`~stonkgs_tpu_torch.api.inference.STonKGsEngine` in fp32 on its
device (the card unless the caller asks for the CPU), and into a forward
composed of ``transformers.BertModel`` modules on the CPU in fp32 that
reproduces the reference's (``stonkgs_model.py:149-258``), the frozen
backbone run with no attention mask as the reference does.  Both run on
the same seeded random rows and :class:`ParityReport` holds each output's
largest absolute deviation.  CLI: ``python -m stonkgs_tpu_torch
verify-parity``.

``transformers`` is imported inside the reference forward only: a machine
that serves the port does not need it.  On the card the comparison turns
TF32 off for its products (and back after it): with TF32 the port's fp32
side would lose about three decimal digits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ParityReport:
    """Largest absolute deviation of each compared output."""
    max_dev_pooled: float
    max_dev_mlm: float
    max_dev_elm: float
    max_dev_nsp: float
    max_dev_logits: Optional[float]  # the classification head, if present
    n_rows: int

    @property
    def max_dev(self) -> float:
        """Largest absolute deviation across all compared outputs."""
        vals = [self.max_dev_pooled, self.max_dev_mlm, self.max_dev_elm,
                self.max_dev_nsp]
        if self.max_dev_logits is not None:
            vals.append(self.max_dev_logits)
        return max(vals)

    def summary(self, tolerance: float = 1e-5) -> str:
        """PASS or FAIL against ``tolerance``, and each output's deviation."""
        status = "PASS" if self.max_dev < tolerance else "FAIL"
        return (f"{status}: max deviation {self.max_dev:.2e} over "
                f"{self.n_rows} rows (pooled {self.max_dev_pooled:.2e}, "
                f"mlm {self.max_dev_mlm:.2e}, elm {self.max_dev_elm:.2e}, "
                f"nsp {self.max_dev_nsp:.2e}"
                + (f", cls {self.max_dev_logits:.2e}" if self.max_dev_logits
                   is not None else "") + ")")


def _reference_forward(sd: Dict[str, torch.Tensor], hf_cfg: dict, kg_table: torch.Tensor,
                       batch: Dict[str, np.ndarray]):
    """The reference's forward from a state dict, with ``transformers``
    modules on the CPU in fp32: (mlm, elm, nsp, pooled, classifier logits
    or None) as numpy."""
    import transformers

    cfg = transformers.BertConfig(**{
        k: v for k, v in hf_cfg.items() if k in transformers.BertConfig().to_dict()})

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    trunk = transformers.BertModel(cfg)
    trunk.load_state_dict(sub("bert."), strict=False)
    backbone = transformers.BertModel(cfg)
    backbone.load_state_dict(sub("lm_backbone."), strict=False)
    trunk.eval()
    backbone.eval()

    half = batch["input_ids"].shape[1] // 2
    ids = torch.as_tensor(batch["input_ids"])
    F = torch.nn.functional
    with torch.no_grad():
        token_emb = backbone(ids[:, :half])[0]          # no attention mask
        ent_emb = kg_table[ids[:, half:]]
        out = trunk(
            inputs_embeds=torch.cat([token_emb, ent_emb], dim=1),
            attention_mask=torch.as_tensor(batch["attention_mask"]),
            token_type_ids=torch.as_tensor(batch["token_type_ids"]),
        )
        seq, pooled = out.last_hidden_state, out.pooler_output
        # BertPredictionHeadTransform: dense -> gelu -> LayerNorm
        h = F.linear(seq, sd["cls.predictions.transform.dense.weight"],
                     sd["cls.predictions.transform.dense.bias"])
        h = F.gelu(h)
        h = F.layer_norm(h, h.shape[-1:], sd["cls.predictions.transform.LayerNorm.weight"],
                         sd["cls.predictions.transform.LayerNorm.bias"],
                         eps=cfg.layer_norm_eps)
        mlm = h[:, :half] @ sd["cls.predictions.text_decoder.weight"].T
        elm = h[:, half:] @ sd["cls.predictions.entity_decoder.weight"].T
        nsp = pooled @ sd["cls.seq_relationship.weight"].T + sd["cls.seq_relationship.bias"]
        cls_logits = None
        if "classifier.weight" in sd:
            cls_logits = pooled @ sd["classifier.weight"].T + sd["classifier.bias"]
    return (mlm.numpy(), elm.numpy(), nsp.numpy(), pooled.numpy(),
            None if cls_logits is None else cls_logits.numpy())


@contextlib.contextmanager
def _no_tf32():
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def verify_parity(
    model_dir: str,
    kg_embedding_path: str,
    kg_random_walk_path: str,
    *,
    n_rows: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> ParityReport:
    """The port on ``device`` against the ``transformers`` forward on the
    CPU, both fp32, on ``n_rows`` random rows (the first with 5 padded
    text positions); every pre-training output and, where the checkpoint
    has one, the classifier's logits."""
    from stonkgs_tpu_torch.api.inference import STonKGsEngine
    from stonkgs_tpu_torch.models import stonkgs
    from stonkgs_tpu_torch.utils import hf_loader

    engine = STonKGsEngine.from_pretrained(
        model_dir, kg_embedding_path, kg_random_walk_path,
        compute_dtype="float32", device=device)
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    half = cfg.text_len
    batch_np = {
        "input_ids": np.concatenate([
            rng.integers(0, cfg.bert.vocab_size, (n_rows, half)),
            rng.integers(0, cfg.kg_vocab_size, (n_rows, cfg.entity_len)),
        ], axis=1),
        "attention_mask": np.ones((n_rows, cfg.seq_len), np.int64),
        "token_type_ids": np.concatenate([
            np.zeros((n_rows, half), np.int64),
            np.ones((n_rows, cfg.entity_len), np.int64)], axis=1),
    }
    batch_np["attention_mask"][0, half - 5: half] = 0  # some text padding
    batch = {k: torch.as_tensor(v, device=engine.device) for k, v in batch_np.items()}

    with torch.no_grad(), _no_tf32():
        outs = stonkgs.pretraining_logits(
            engine.params, cfg, batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"])
        mlm, elm, nsp, pooled = (t.float().cpu().numpy() for t in outs)
        cls_logits = None
        if "classifier" in engine.params:
            cls_logits = stonkgs.classification_logits(
                engine.params, cfg, batch).float().cpu().numpy()

    sd = hf_loader.load_state_dict(model_dir)
    hf_cfg = hf_loader.load_config(model_dir)
    kg_table = engine.params["kg_backbone"].float().cpu()
    r_mlm, r_elm, r_nsp, r_pooled, r_cls = _reference_forward(sd, hf_cfg, kg_table, batch_np)

    dev = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    report = ParityReport(
        max_dev_pooled=dev(pooled, r_pooled),
        max_dev_mlm=dev(mlm, r_mlm),
        max_dev_elm=dev(elm, r_elm),
        max_dev_nsp=dev(nsp, r_nsp),
        max_dev_logits=(dev(cls_logits, r_cls)
                        if cls_logits is not None and r_cls is not None else None),
        n_rows=n_rows,
    )
    logger.info(report.summary())
    return report
