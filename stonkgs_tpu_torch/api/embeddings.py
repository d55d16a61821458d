"""Embedding extraction over DataFrames, as the reference's API.

The port of the JAX package's ``stonkgs_tpu/api/embeddings.py``:
``preprocess_df_for_embeddings`` and ``get_stonkgs_embeddings``
(the reference's ``stonkgs_for_embeddings.py:26-186``) on DataFrames with
``source``/``target``/``evidence`` columns, batched on the engine's device
instead of a row at a time.  ``get_stonkgs_embeddings`` takes a port
engine; a hub name would need a download, which is not ported.  pandas is
imported inside the functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from stonkgs_tpu_torch.api.inference import STonKGsEngine
from stonkgs_tpu_torch.data.artifacts import load_kg_artifacts
from stonkgs_tpu_torch.data.fast_tokenizer import FastBertTokenizer
from stonkgs_tpu_torch.data.preprocessing import preprocess_for_embeddings


def preprocess_df_for_embeddings(
    df,
    *,
    embedding_name_to_vector_path: str,
    embedding_name_to_random_walk_path: str,
    vocab_file_path: str,
    sep_id: int = 102,
    unk_id: int = 100,
    mask_id: int = 103,
    apply_masking: bool = True,
    seed: int = 0,
):
    """DataFrame(source, target, evidence) -> a DataFrame of features.

    ``apply_masking=True`` keeps the reference's random 15% masking at
    inference (``stonkgs_for_embeddings.py:133-143``); pass False for
    deterministic embeddings."""
    import pandas as pd

    artifacts = load_kg_artifacts(embedding_name_to_vector_path,
                                  embedding_name_to_random_walk_path)
    feats = preprocess_for_embeddings(
        df["source"].to_numpy(object), df["target"].to_numpy(object),
        df["evidence"].tolist(), artifacts, FastBertTokenizer(vocab_file_path),
        sep_id=sep_id, unk_id=unk_id, mask_id=mask_id,
        apply_masking=apply_masking, seed=seed,
    )
    return pd.DataFrame({k: list(v) for k, v in feats.items()})


def get_stonkgs_embeddings(
    preprocessed_df,
    pretrained_stonkgs_model_name=None,
    list_of_indices: Optional[list] = None,
):
    """Preprocessed DataFrame -> DataFrame with an ``embedding`` column.

    The reference function's positions (``stonkgs_for_embeddings.py:
    158-163``); the second argument is a :class:`STonKGsEngine` (build one
    with ``STonKGsEngine.from_pretrained`` from local files).  A hub name
    or None raises: the port does not download models."""
    import pandas as pd

    if not isinstance(pretrained_stonkgs_model_name, STonKGsEngine):
        raise ValueError(
            f"get_stonkgs_embeddings needs an STonKGsEngine, got "
            f"{pretrained_stonkgs_model_name!r}: downloading a model from the hub is not "
            "ported; load a local checkpoint with STonKGsEngine.from_pretrained")
    engine = pretrained_stonkgs_model_name
    if list_of_indices is not None:
        preprocessed_df = preprocessed_df.iloc[list_of_indices]
    features = {k: np.stack(preprocessed_df[k].to_numpy())
                for k in ("input_ids", "attention_mask", "token_type_ids")}
    pooled = engine.embed(features)
    return pd.DataFrame({"embedding": [row.tolist() for row in pooled]})
