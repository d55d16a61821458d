"""Inference API: the published models and ``infer*`` over DataFrames,
rows or INDRA statements.

The port of the JAX package's ``stonkgs_tpu/api/api.py`` (the reference's
``api.py``):

* the published fine-tuned models: each task's Zenodo record and class
  columns, ``ensure_<task>`` (the checkpoint's files through the cache of
  :mod:`stonkgs_tpu_torch.utils.cache`, fetched only when missing),
  ``get_<task>_model`` (an engine built once by
  :meth:`~stonkgs_tpu_torch.api.inference.STonKGsEngine.from_pretrained`
  on those files and the node2vec TSVs and vocabulary of
  ``ensure_embeddings`` / ``ensure_walks`` / ``ensure_vocab``) and
  ``infer_<task>``;
* the input polymorphism (a DataFrame with ``source``/``target``/
  ``evidence`` columns, a list of (source, target, evidence) rows, or
  INDRA statements as objects or JSON dicts) and ``infer`` /
  ``infer_iter`` / ``infer_concat`` / ``infer_concat_iter`` on any engine.

Every row is classified in padded batches on the engine's device instead
of the reference's batch-size-1 loop.  The published models run on the
card; ``device="cpu"`` (as the tests pass it) asks for the CPU.  A filled
cache needs no network.  pandas is imported inside the functions that
build or return a DataFrame.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np

from stonkgs_tpu_torch.api.inference import STonKGsEngine
from stonkgs_tpu_torch.constants import EMBEDDINGS_URL, VOCAB_URL, WALKS_URL
from stonkgs_tpu_torch.data.indra_extraction import statement_edges
from stonkgs_tpu_torch.utils.cache import ensure

logger = logging.getLogger(__name__)

InferenceHint = Union["pandas.DataFrame", List[List[str]], list]  # noqa: F821

# Zenodo record ids of the published fine-tuned models
SPECIES_RECORD = "5205530"
LOCATION_RECORD = "5205553"
DISEASE_RECORD = "5205592"
CORRECT_MULTICLASS_RECORD = "5206139"
CORRECT_BINARY_RECORD = "5205989"
CELL_LINE_RECORD = "5205915"

# each task's class columns, in the order of the models' logits
POLARITY_COLUMNS = ["down", "up"]
INTERACTION_COLUMNS = ["direct_interaction", "indirect_interaction"]
SPECIES_COLUMNS = ["mouse", "rat", "human"]
LOCATION_COLUMNS = [
    "extracellular_space", "cell_membrane", "cell_nucleus",
    "extracellular_matrix", "cytoplasm",
]
DISEASE_COLUMNS = [
    "neuroblastoma", "multiple_myeloma", "lung_non-small_cell_carcinomaleukemia",
    "breast_cancer", "lung_cancer", "atherosclerosis", "osteosarcoma",
    "melanoma", "leukemia", "colon_cancer",
]
CORRECT_MULTICLASS_COLUMNS = [
    "act_vs_amt", "grounding", "hypothesis", "entity_boundaries",
    "no_relation", "correct", "wrong_relation", "polarity",
]
CORRECT_BINARY_COLUMNS = ["incorrect", "correct"]
CELL_LINE_COLUMNS = [
    "HeLa", "THP-1", "LNCAP", "COS-1", "DMS_114", "NIH-3T3", "HEK293",
    "MCF7", "Hep_G2", "U-937",
]

KEEP_COLUMNS = ["input_ids", "attention_mask", "token_type_ids"]


def ensure_walks() -> Path:
    """The node2vec random walks of the published KG (Zenodo 5205687)."""
    return ensure(WALKS_URL)


def ensure_embeddings() -> Path:
    """The node2vec embeddings of the published KG (Zenodo 5205687)."""
    return ensure(EMBEDDINGS_URL)


def ensure_vocab() -> Path:
    """BioBERT's vocabulary file."""
    return ensure(VOCAB_URL, "misc")


def _ensure_fine_tuned(submodule: str, record: str) -> Path:
    ensure(f"https://zenodo.org/record/{record}/files/config.json", submodule)
    ensure(f"https://zenodo.org/record/{record}/files/training_args.bin", submodule)
    return ensure(f"https://zenodo.org/record/{record}/files/pytorch_model.bin", submodule)


def _get_engine(f: Callable[[], Path], device: str) -> STonKGsEngine:
    path = f().parent
    logger.info("loading the STonKGs sequence classifier from %s", path)
    return STonKGsEngine.from_pretrained(
        str(path),
        kg_embedding_path=str(ensure_embeddings()),
        kg_random_walk_path=str(ensure_walks()),
        vocab_file=str(ensure_vocab()),
        device=device,
    )


def ensure_species() -> Path:
    """The species model (Zenodo 5205530; about 1.4 GB)."""
    return _ensure_fine_tuned("species", SPECIES_RECORD)


def ensure_location() -> Path:
    """The location model."""
    return _ensure_fine_tuned("location", LOCATION_RECORD)


def ensure_disease() -> Path:
    """The disease model."""
    return _ensure_fine_tuned("disease", DISEASE_RECORD)


def ensure_correct_multiclass() -> Path:
    """The correct (multiclass) model."""
    return _ensure_fine_tuned("correct_multiclass", CORRECT_MULTICLASS_RECORD)


def ensure_correct_binary() -> Path:
    """The correct (binary) model."""
    return _ensure_fine_tuned("correct_binary", CORRECT_BINARY_RECORD)


def ensure_cell_line() -> Path:
    """The cell-line model."""
    return _ensure_fine_tuned("cell_line", CELL_LINE_RECORD)


@lru_cache(maxsize=1)
def get_species_model(device: str = "cuda") -> STonKGsEngine:
    """The species model's engine, built once."""
    return _get_engine(ensure_species, device)


@lru_cache(maxsize=1)
def get_location_model(device: str = "cuda") -> STonKGsEngine:
    """The location model's engine, built once."""
    return _get_engine(ensure_location, device)


@lru_cache(maxsize=1)
def get_disease_model(device: str = "cuda") -> STonKGsEngine:
    """The disease model's engine, built once."""
    return _get_engine(ensure_disease, device)


@lru_cache(maxsize=1)
def get_correct_multiclass_model(device: str = "cuda") -> STonKGsEngine:
    """The correct (multiclass) model's engine, built once."""
    return _get_engine(ensure_correct_multiclass, device)


@lru_cache(maxsize=1)
def get_correct_binary_model(device: str = "cuda") -> STonKGsEngine:
    """The correct (binary) model's engine, built once."""
    return _get_engine(ensure_correct_binary, device)


@lru_cache(maxsize=1)
def get_cell_line_model(device: str = "cuda") -> STonKGsEngine:
    """The cell-line model's engine, built once."""
    return _get_engine(ensure_cell_line, device)


def infer_species(data: InferenceHint, *, device: str = "cuda"):
    """The species probabilities of each row: the header, then the rows."""
    return infer_concat(get_species_model(device), data, columns=SPECIES_COLUMNS)


def infer_locations(data: InferenceHint, *, device: str = "cuda"):
    """The location probabilities of each row."""
    return infer_concat(get_location_model(device), data, columns=LOCATION_COLUMNS)


def infer_diseases(data: InferenceHint, *, device: str = "cuda"):
    """The disease probabilities of each row."""
    return infer_concat(get_disease_model(device), data, columns=DISEASE_COLUMNS)


def infer_correct_multiclass(data: InferenceHint, *, device: str = "cuda"):
    """The correct (multiclass) probabilities of each row."""
    return infer_concat(get_correct_multiclass_model(device), data,
                        columns=CORRECT_MULTICLASS_COLUMNS)


def infer_correct_binary(data: InferenceHint, *, device: str = "cuda"):
    """The correct (binary) probabilities of each row.

    >>> from stonkgs_tpu_torch import infer_correct_binary
    >>> rows = [["p(HGNC:17927 ! SENP1)", "p(HGNC:4910 ! HIF1A)",
    ...          "Hence, deSUMOylation of HIF-1alpha by SENP1 could prevent "
    ...          "degradation of HIF-1alpha"]]
    >>> df = infer_correct_binary(rows)  # doctest: +SKIP
    """
    return infer_concat(get_correct_binary_model(device), data,
                        columns=CORRECT_BINARY_COLUMNS)


def infer_cell_lines(data: InferenceHint, *, device: str = "cuda"):
    """The cell-line probabilities of each row."""
    return infer_concat(get_cell_line_model(device), data, columns=CELL_LINE_COLUMNS)


INDRA_DF_COLUMNS = ["stmt_hash", "belief", "source", "target", "evidence"]


def _convert_indra_statements(statements) -> "pandas.DataFrame":  # noqa: F821
    """INDRA statements (objects or JSON dicts) -> rows, one per edge
    with evidence text, through the BEL conversion of
    :func:`~stonkgs_tpu_torch.data.indra_extraction.statement_edges`."""
    import pandas as pd

    rows = []
    for stmt in statements:
        stmt_json = stmt.to_json() if hasattr(stmt, "to_json") else stmt
        h = stmt_json.get("matches_hash", "")
        belief = stmt_json.get("belief", "")
        for (u, _), _rel, (v, _), data in statement_edges(stmt_json):
            if not data["evidence"]:
                continue
            rows.append((h, belief, u, v, data["evidence"]))
    return pd.DataFrame(rows, columns=INDRA_DF_COLUMNS)


def _prepare_df(data: InferenceHint):
    """DataFrame | [(source, target, evidence), ...] | INDRA statements."""
    import pandas as pd

    if isinstance(data, pd.DataFrame):
        return data
    if not isinstance(data, list):
        raise TypeError(f"source df has invalid type: {type(data)}")
    if isinstance(data[0], (list, tuple)):
        return pd.DataFrame(data, columns=["source", "target", "evidence"])
    if hasattr(data[0], "to_json") or (isinstance(data[0], dict) and "type" in data[0]):
        return _convert_indra_statements(data)
    raise TypeError(f"row has invalid type: {type(data[0])}")


def infer(engine: STonKGsEngine, data: InferenceHint):
    """Run inference; returns (list of logits, list of probabilities)."""
    raw, probs = [], []
    for r, p in infer_iter(engine, data):
        raw.append(r)
        probs.append(p)
    return raw, probs


def infer_iter(engine: STonKGsEngine, data: InferenceHint) -> Iterable[Tuple]:
    """Yield (logits, probabilities) a row, computed in batches."""
    df = _prepare_df(data)
    feats = engine.preprocess(
        df["source"].to_numpy(object), df["target"].to_numpy(object),
        df["evidence"].tolist(),
    )
    logits = engine.logits(feats)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    for lg, p in zip(logits, probs):
        yield lg, p.tolist()


def infer_concat(engine: STonKGsEngine, data: InferenceHint, *,
                 columns: Optional[List[str]] = None,
                 as_dataframe: bool = False):
    """Run inference, concatenating probability columns onto the input rows
    (an iterator of the header and then the rows, or a DataFrame)."""
    rv = iter(infer_concat_iter(engine, data, columns=columns))
    if as_dataframe:
        import pandas as pd

        header = next(rv)
        return pd.DataFrame(rv, columns=header)
    return rv


def infer_concat_iter(engine: STonKGsEngine, data: InferenceHint,
                      columns: Optional[List[str]] = None) -> Iterable:
    """Yield the header, then the input rows extended with their class
    probabilities.  Without ``columns`` the header names the classes
    ``class_<i>``; the header always comes first."""
    df = _prepare_df(data)
    if columns is None:
        columns = [f"class_{i}" for i in range(engine.cfg.num_labels)]
    yield (*df.columns, *columns)
    for row, (_lg, probs) in zip(df.values, infer_iter(engine, df)):
        yield (*row, *probs)
