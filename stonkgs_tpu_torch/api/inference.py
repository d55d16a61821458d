"""Inference engine of the port: embed / classify batches on the card.

The port of ``STonKGsEngine`` from the JAX package's
``stonkgs_tpu/api/inference.py``: built from a config plus parameters, by
:meth:`STonKGsEngine.from_pretrained` from the files a user of the
published models has (an HF checkpoint directory, the node2vec TSVs and
the BioBERT vocabulary), or by
:meth:`STonKGsEngine.from_default_pretrained` from the published ones in
the cache (:mod:`stonkgs_tpu_torch.utils.cache`); then
:meth:`~STonKGsEngine.preprocess` turns (source, target, evidence) rows
into features and
:meth:`~STonKGsEngine.embed` serves them (:meth:`~STonKGsEngine.embed_stream`
does both, chunk by chunk, overlapping the host's preprocessing with the
card's forwards).
Every batch is dispatched before any is fetched: CUDA launches are
asynchronous, so the card runs the batches back to back and the host
waits only in :meth:`STonKGsEngine._fetch`, the one place that copies to
the host.

The engine runs on the card (``device="cuda"``) unless the caller asks
for the CPU, as the tests do; with no CUDA device it raises rather than
running on the CPU.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import partial
from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from stonkgs_tpu_torch.config import BertConfig, STonKGsConfig
from stonkgs_tpu_torch.data.artifacts import KGArtifacts, load_kg_artifacts
from stonkgs_tpu_torch.data.fast_tokenizer import FastBertTokenizer
from stonkgs_tpu_torch.data.preprocessing import preprocess_for_embeddings
from stonkgs_tpu_torch.data.transe import (
    TransEArtifacts,
    assemble_transe_part,
    load_transe_artifacts,
    preprocess_transe_for_finetuning,
)
from stonkgs_tpu_torch.models import stonkgs
from stonkgs_tpu_torch.utils import hf_export, hf_loader
from stonkgs_tpu_torch.utils.batching import host_to_device, iter_padded_batches
from stonkgs_tpu_torch.utils.convert import params_to

BATCH_KEYS = ("input_ids", "attention_mask", "token_type_ids")


@dataclasses.dataclass
class STonKGsEngine:
    """STonKGs model + parameters on a device, serving pooled embeddings
    and classification logits over preprocessed features."""

    cfg: STonKGsConfig
    params: dict
    compute_dtype: str = "bfloat16"
    batch_size: int = 64
    # Length-bucketed speed mode (opt-in; None = exact-parity shapes).
    # e.g. (64, 128): rows whose true text length fits a bucket run the
    # frozen backbone at that length and the trunk at bucket+entity_len,
    # the entity half kept on its original position rows via position_ids.
    length_buckets: Optional[Tuple[int, ...]] = None
    device: str = "cuda"
    # what preprocess needs: a tokenizer (BertTokenizer's surface) and the
    # KG artifacts (node2vec KGArtifacts, or TransEArtifacts)
    tokenizer: Optional[object] = None
    artifacts: Optional[Union[KGArtifacts, TransEArtifacts]] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "STonKGsEngine: no CUDA device; pass device='cpu' to run the "
                "plain path on the CPU")
        self.params = params_to(self.params, self.device)
        dtype = getattr(torch, self.compute_dtype)
        self._pooler = partial(stonkgs.pooler_output, cfg=self.cfg,
                               compute_dtype=dtype)
        self._classify = partial(stonkgs.classification_logits, cfg=self.cfg,
                                 compute_dtype=dtype)
        self._bucket_poolers = {}
        self._bucket_classifiers = {}
        if self.length_buckets:
            buckets = tuple(sorted(set(int(b) for b in self.length_buckets)))
            if any(b <= 0 or b > self.cfg.text_len for b in buckets):
                raise ValueError(
                    f"length_buckets {buckets} must lie in "
                    f"(0, text_len={self.cfg.text_len}]")
            self.length_buckets = buckets
            for b in buckets:
                if b == self.cfg.text_len:
                    continue  # full shape = the parity functions above
                bcfg = self.cfg.replace(text_len=b)
                self._bucket_poolers[b] = partial(
                    stonkgs.pooler_output, cfg=bcfg, compute_dtype=dtype)
                self._bucket_classifiers[b] = partial(
                    stonkgs.classification_logits, cfg=bcfg,
                    compute_dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        kg_embedding_path: str,
        kg_random_walk_path: Optional[str] = None,
        vocab_file: Optional[str] = None,
        num_labels: Optional[int] = None,
        variant: str = "stonkgs",
        **kw,
    ) -> "STonKGsEngine":
        """Load an HF-format checkpoint, the KG artifacts and (optionally)
        the vocabulary; ``kw`` are the engine's fields (``device``,
        ``compute_dtype``, ``batch_size``, ``length_buckets``).

        The parameters stay fp32, as saved; the KG table is built on the
        engine's device from the LM backbone.  ``variant="transe"`` loads
        TransE embeddings (no walks file) with the 256 + 4 layout."""
        sd = hf_loader.load_state_dict(model_dir)
        hf_cfg = hf_loader.load_config(model_dir)
        bert_cfg = BertConfig.from_hf_dict(hf_cfg)
        kg_vocab = hf_loader.infer_kg_vocab_size(sd)
        num_labels = num_labels or hf_cfg.get("num_labels")
        if variant == "transe":
            artifacts = load_transe_artifacts(kg_embedding_path)
            cfg = STonKGsConfig(
                bert=bert_cfg, kg_vocab_size=kg_vocab,
                text_len=bert_cfg.max_position_embeddings - 4, entity_len=4,
                num_labels=num_labels)
        elif variant == "stonkgs":
            if kg_random_walk_path is None:
                raise ValueError("variant 'stonkgs' needs kg_random_walk_path")
            artifacts = load_kg_artifacts(kg_embedding_path, kg_random_walk_path)
            half = artifacts.rw_len * 2 + 2
            cfg = STonKGsConfig(bert=bert_cfg, kg_vocab_size=kg_vocab,
                                text_len=half, entity_len=half, num_labels=num_labels)
        else:
            raise ValueError(f"unknown variant {variant!r}: 'stonkgs' or 'transe'")
        params = hf_loader.stonkgs_params_from_state_dict(sd, cfg)
        del sd
        tokenizer = FastBertTokenizer(vocab_file) if vocab_file else None
        engine = cls(cfg=cfg, params=params, tokenizer=tokenizer,
                     artifacts=artifacts, **kw)
        engine.params["kg_backbone"] = stonkgs.build_kg_table(
            engine.params["lm_backbone"], cfg.bert, artifacts.vectors)
        return engine

    @classmethod
    def from_default_pretrained(cls, model_name: Optional[str] = None,
                                **kw) -> "STonKGsEngine":
        """A published HF-hub checkpoint (``stonkgs/stonkgs-150k`` unless
        ``model_name`` names another) with the published node2vec TSVs
        and BioBERT vocabulary, through the cache: the hub's files under
        ``hub/<org>--<name>``, each fetched only when missing, then
        :meth:`from_pretrained` (``kw`` are its engine fields)."""
        from stonkgs_tpu_torch.api.api import ensure_embeddings, ensure_vocab, ensure_walks
        from stonkgs_tpu_torch.constants import DEFAULT_PRETRAINED_MODEL
        from stonkgs_tpu_torch.utils.cache import ensure

        name = model_name or DEFAULT_PRETRAINED_MODEL
        sub = "hub/" + name.replace("/", "--")
        base = f"https://huggingface.co/{name}/resolve/main"
        ensure(f"{base}/config.json", sub)
        ckpt = ensure(f"{base}/pytorch_model.bin", sub)
        return cls.from_pretrained(
            str(ckpt.parent),
            kg_embedding_path=str(ensure_embeddings()),
            kg_random_walk_path=str(ensure_walks()),
            vocab_file=str(ensure_vocab()),
            **kw,
        )

    def save_pretrained(self, output_dir: str) -> str:
        """Export to an HF-format checkpoint directory (fp32; the KG table,
        rebuilt from the artifacts at load, is not written)."""
        return hf_export.save_pretrained(self.params, self.cfg, output_dir)

    def preprocess(
        self, sources, targets, evidences,
        *, relations=None, apply_masking: bool = True, seed: int = 0,
    ) -> Dict[str, np.ndarray]:
        """(source, target, evidence) rows -> model features, as the
        reference's ``preprocess_df_for_embeddings`` (with its 15% masking
        unless ``apply_masking=False``).

        A TransE-variant engine takes ``relations`` too, and refuses rows
        whose head, relation or tail is not in its embeddings (inference
        keeps its rows 1:1)."""
        if self.tokenizer is None or self.artifacts is None:
            raise ValueError("preprocess needs the engine's tokenizer and artifacts "
                             "(from_pretrained with a vocab_file)")
        if isinstance(self.artifacts, TransEArtifacts):
            if relations is None:
                raise ValueError("TransE preprocessing needs relations")
            ent_part = assemble_transe_part(
                list(sources), list(relations), list(targets),
                self.artifacts, self.cfg.sep_id)
            keep = ent_part[1]
            if not keep.all():
                bad = [i for i, k in enumerate(keep) if not k]
                raise ValueError(
                    f"rows {bad[:10]}{'...' if len(bad) > 10 else ''} contain "
                    "head/relation/tail names missing from the TransE "
                    "embeddings; filter them out before inference")
            feats = preprocess_transe_for_finetuning(
                list(sources), list(relations), list(targets),
                list(evidences), np.zeros(len(evidences), np.int64),
                self.artifacts, self.tokenizer,
                text_part_length=self.cfg.text_len, sep_id=self.cfg.sep_id,
                ent_part=ent_part,
            )
            feats.pop("labels")
            return feats
        return preprocess_for_embeddings(
            np.asarray(sources, object), np.asarray(targets, object),
            list(evidences), self.artifacts, self.tokenizer,
            sep_id=self.cfg.sep_id, unk_id=self.cfg.unk_id,
            mask_id=self.cfg.mask_id,
            apply_masking=apply_masking, seed=seed,
        )

    def _bucket_features(self, features: Dict[str, np.ndarray]):
        """Partition rows by true text length into the buckets.

        Yields ``(bucket_len, row_indices, sub_features, position_ids)``
        where sub_features carry the text half truncated to bucket_len and
        position_ids keep the entity half on its original position rows
        (``[0..b-1, text_len..text_len+entity_len-1]``).  Rows longer than
        every bucket run at the full parity shape (bucket_len ==
        cfg.text_len, position_ids None)."""
        tl, el = self.cfg.text_len, self.cfg.entity_len
        am = np.asarray(features["attention_mask"])
        true_len = am[:, :tl].sum(axis=1)
        buckets = list(self.length_buckets or ())
        if not buckets or buckets[-1] < tl:
            buckets.append(tl)
        taken = np.zeros(len(am), bool)
        if 0 < len(am) <= self.batch_size:
            # Latency-shaped request (one padded batch either way): run the
            # WHOLE request at the smallest bucket that fits its longest row
            # rather than one round trip per bucket.
            buckets = [b for b in buckets if true_len.max() <= b or b == tl]
            true_len = np.full(len(am), int(true_len.max()))
        for b in buckets:
            idx = np.nonzero(~taken & (true_len <= b))[0] if b < tl \
                else np.nonzero(~taken)[0]
            taken[idx] = True
            if len(idx) == 0:
                continue
            if b == tl:
                sub = {k: np.asarray(features[k])[idx]
                       for k in BATCH_KEYS if k in features}
                yield b, idx, sub, None
                continue
            sub = {}
            for k in BATCH_KEYS:
                if k in features:
                    v = np.asarray(features[k])[idx]
                    sub[k] = np.concatenate([v[:, :b], v[:, tl:]], axis=1)
            pos = np.concatenate(
                [np.arange(b), np.arange(tl, tl + el)]).astype(np.int64)
            yield b, idx, sub, pos

    @torch.inference_mode()
    def _dispatch(self, features: Dict[str, np.ndarray], fns, full_fn):
        """Dispatch forwards (bucketed when configured) and the copies of
        their outputs to the host, without waiting for any.

        Each output is copied into pinned host memory right behind its
        forward in stream order, so a later dispatch does not delay it.
        Returns ``((copies, event), n_rows)``: copies are
        ``(host_tensor, dest_row_indices)``, the event (None on the CPU)
        is recorded after the last copy."""
        n = len(features["input_ids"])
        copies = []
        if not self.length_buckets:
            groups = [(self.cfg.text_len, np.arange(n), features, None)]
        else:
            groups = self._bucket_features(features)
        for b, idx, sub, pos in groups:
            fn = full_fn if pos is None else fns[b]
            off = 0
            for piece, valid in iter_padded_batches(
                    sub, BATCH_KEYS, self.batch_size, self.device):
                if pos is not None:
                    piece["position_ids"] = host_to_device(pos[None], self.device)
                out = fn(self.params, batch=piece)[:valid].float()
                if out.is_cuda:
                    out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True).copy_(
                        out, non_blocking=True)
                copies.append((out, idx[off: off + valid]))
                off += valid
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return (copies, event), n

    @staticmethod
    def _fetch(pending, n: int) -> np.ndarray:
        """Wait for the dispatched copies (the one place the host waits
        for the card) and assemble them in original row order."""
        copies, event = pending
        if not copies:
            return np.zeros((n, 0), np.float32)
        if event is not None:
            event.synchronize()
        out = np.zeros((n, copies[0][0].shape[-1]), np.float32)
        for host, dest in copies:
            out[dest] = host.numpy()
        return out

    def embed(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        """Pooled [CLS] embeddings, (N, hidden) float32."""
        if len(features["input_ids"]) == 0:
            return np.zeros((0, self.cfg.bert.hidden_size), np.float32)
        return self._fetch(*self._dispatch(
            features, self._bucket_poolers, self._pooler))

    def logits(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        """Classification logits, (N, num_labels) float32."""
        if "classifier" not in self.params:
            raise ValueError("no classification head loaded")
        if len(features["input_ids"]) == 0:
            return np.zeros((0, self.cfg.num_labels or 0), np.float32)
        return self._fetch(*self._dispatch(
            features, self._bucket_classifiers, self._classify))

    def predict_proba(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        """Softmax class probabilities over preprocessed features."""
        lg = self.logits(features)
        e = np.exp(lg - lg.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def embed_stream(
        self, rows: Iterable, *, chunk_rows: int = 4096,
        apply_masking: bool = True, seed: int = 0,
    ) -> Iterator[np.ndarray]:
        """Pooled embeddings over an iterable of (source, target, evidence)
        rows, a chunk of ``chunk_rows`` at a time, without holding the
        corpus: yields (N_chunk, hidden) float32 arrays.

        Chunk i+1 is preprocessed on the host while chunk i's forwards run
        on the card: a chunk is dispatched and fetched only after the next
        one is dispatched, so :meth:`_fetch` is the one place the host
        waits.  Each chunk is preprocessed with the same ``seed``, as the
        JAX package's ``embed_stream``."""
        rows = iter(rows)
        pending = None
        while True:
            chunk = list(itertools.islice(rows, chunk_rows))
            if not chunk:
                break
            src, tgt, ev = zip(*chunk)
            feats = self.preprocess(list(src), list(tgt), list(ev),
                                    apply_masking=apply_masking, seed=seed)
            dispatched = self._dispatch(feats, self._bucket_poolers, self._pooler)
            if pending is not None:
                yield self._fetch(*pending)
            pending = dispatched
        if pending is not None:
            yield self._fetch(*pending)
