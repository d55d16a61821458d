"""Inference API: ``infer*`` over DataFrames, rows or INDRA statements.

The local half of the JAX package's ``stonkgs_tpu/api/api.py`` (the
reference's ``api.py``): the input polymorphism (a DataFrame with
``source``/``target``/``evidence`` columns, a list of (source, target,
evidence) rows, or INDRA statements as objects or JSON dicts) and
``infer`` / ``infer_iter`` / ``infer_concat`` / ``infer_concat_iter``, on
an engine the caller built (:class:`~stonkgs_tpu_torch.api.inference.
STonKGsEngine`, e.g. by ``from_pretrained`` from local files).  Every
row is classified in padded batches on the engine's device instead of the
reference's batch-size-1 loop.

Not ported here: ``ensure_*``, ``get_*_model`` and ``infer_species`` and
its siblings, which download the published models.  pandas is imported
inside the functions that build or return a DataFrame.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import numpy as np

from stonkgs_tpu_torch.api.inference import STonKGsEngine
from stonkgs_tpu_torch.data.indra_extraction import statement_edges

InferenceHint = Union["pandas.DataFrame", List[List[str]], list]  # noqa: F821

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
