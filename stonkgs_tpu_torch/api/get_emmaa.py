"""Demo: assess a whole EMMAA model with the correct/incorrect classifier.

The port of the JAX package's ``stonkgs_tpu/api/get_emmaa.py`` (the
reference's ``api/get_emmaa.py``): fetch an assembled EMMAA statement
dump through the cache, run ``infer_correct_binary`` over every
statement, write a results TSV, select curation candidates from the
belief-versus-STonKGs quadrants (0.2 / 0.85 thresholds), pickle the
selected statements and, where matplotlib and seaborn are installed, plot
a scatter.  The model runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import csv
import gzip
import json
import logging
import pickle
from pathlib import Path
from typing import List, Tuple

from stonkgs_tpu_torch.utils.cache import ensure

logger = logging.getLogger(__name__)

MARM_URL = "https://emmaa.s3.amazonaws.com/assembled/marm_model/statements_2021-08-17-17-31-53.gz"
RAS_URL = "https://emmaa.s3.amazonaws.com/assembled/rasmachine/statements_2021-08-16-19-22-38.gz"
COVID_URL = "https://emmaa.s3.amazonaws.com/assembled/covid19/statements_2021-08-16-20-29-07.gz"
NF_URL = "https://emmaa.s3.amazonaws.com/assembled/nf/statements_2021-08-16-18-37-34.gz"
VT_URL = "https://emmaa.s3.amazonaws.com/assembled/vitiligo/statements_2021-08-17-18-38-35.gz"

BELIEF_LOWER, BELIEF_UPPER = 0.2, 0.85
STONKGS_LOWER, STONKGS_UPPER = 0.2, 0.85


def get_statements(url: str) -> Tuple[Path, List[dict]]:
    """The cached EMMAA statement dump (a gzipped JSON list) and its
    statements."""
    path = ensure(url, f"demos/emmaa/{url.split('/')[-2]}")
    with gzip.open(path, "rt") as f:
        statements = json.load(f)
    return path, statements


def select_curation_candidates(df) -> set:
    """The statement hashes in the four corners where the belief and the
    model's ``correct`` probability are both extreme."""
    idx = (
        ((df.belief < BELIEF_LOWER) & (df.correct < STONKGS_LOWER))
        | ((df.belief < BELIEF_LOWER) & (df.correct > STONKGS_UPPER))
        | ((df.belief > BELIEF_UPPER) & (df.correct < STONKGS_LOWER))
        | ((df.belief > BELIEF_UPPER) & (df.correct > STONKGS_UPPER))
    )
    return set(df.loc[idx].stmt_hash.unique())


def run_emmaa_demo(url: str = VT_URL, *, device: str = "cuda"):
    """The curation demo end to end; returns the results TSV's and the
    curation pickle's paths (beside the cached dump)."""
    import pandas as pd

    from stonkgs_tpu_torch.api import api

    statements_path, statements = get_statements(url)
    results_path = statements_path.with_suffix(".results.tsv")
    scatter_path = statements_path.with_suffix(".scatter.svg")
    curation_path = statements_path.with_suffix(".curation.pkl")

    it = iter(api.infer_correct_binary(statements, device=device))
    header = next(it)
    first = next(it)
    with results_path.open(mode="w") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(header)
        writer.writerow(first)
        writer.writerows(it)

    # stmt_hash stays a string: pandas would parse numeric hashes to
    # int64, and the membership test below would never match
    df = pd.read_csv(results_path, usecols=[0, 1, 6], sep="\t", dtype={"stmt_hash": str})
    curate_hashes = {str(h) for h in select_curation_candidates(df)}
    logger.info("Got %d statements for curation", len(curate_hashes))
    export = [s for s in statements if str(s.get("matches_hash")) in curate_hashes]
    with curation_path.open("wb") as f:
        pickle.dump(export, f)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns

        fig, ax = plt.subplots(1, 1)
        sns.scatterplot(data=df, x="correct", y="belief", ax=ax)
        fig.savefig(scatter_path)
    except ImportError:
        logger.warning("matplotlib/seaborn unavailable; skipping the scatter plot")
    return results_path, curation_path
