"""Constants and directory layout.

The port's copy of the JAX package's ``stonkgs_tpu/constants.py`` (the
reference's ``constants.py``): a data/models/logs directory tree,
dotenv-style environment configuration, the backbone model ids and the
published artifacts' locations.  The directories are made lazily
(:func:`ensure_dirs`), not at import, and the root is ``STONKGS_TPU_HOME``,
the JAX package's variable: one filled home (and cache, see
:mod:`stonkgs_tpu_torch.utils.cache`) serves both packages, since the
files are the same published artifacts.
"""

from __future__ import annotations

import os
from pathlib import Path


def _load_dotenv(path: str = ".env") -> None:
    """Minimal dotenv loader (the reference uses python-dotenv): KEY=VALUE
    lines fill ``os.environ`` without overriding variables already set."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ.setdefault(key.strip(), value.strip().strip("'\""))


_load_dotenv()

HOME = Path(os.getenv("STONKGS_TPU_HOME", Path.home() / ".data" / "stonkgs_tpu"))

DATA_DIR = HOME / "data"
RAW_DIR = DATA_DIR / "raw"
INPUT_DIR = DATA_DIR / "input"
OUTPUT_DIR = DATA_DIR / "output"
MISC_DIR = DATA_DIR / "misc"

CORRECT_DIR = INPUT_DIR / "correct_incorrect"
DISEASE_DIR = INPUT_DIR / "disease"
LOCATION_DIR = INPUT_DIR / "location"
CELL_LINE_DIR = INPUT_DIR / "cell_line"
CELL_TYPE_DIR = INPUT_DIR / "cell_type"
ORGAN_DIR = INPUT_DIR / "organ"
SPECIES_DIR = INPUT_DIR / "species"
RELATION_TYPE_DIR = INPUT_DIR / "relation_type"

PRETRAINING_DIR = INPUT_DIR / "pretraining"
PRETRAINING_PATH = PRETRAINING_DIR / "pretraining_triples.tsv"
PRETRAINING_PROT_PATH = PRETRAINING_DIR / "pretraining_ppi_prot.tsv"

MODELS_DIR = HOME / "models"
KG_HPO_DIR = MODELS_DIR / "kg-hpo"
STONKGS_PRETRAINING_DIR = MODELS_DIR / "stonkgs-pretraining"
PROTSTONKGS_PRETRAINING_DIR = MODELS_DIR / "protstonkgs-pretraining"
TRANSESTONKGS_PRETRAINING_DIR = MODELS_DIR / "transestonkgs-pretraining"
STONKGS_OUTPUT_DIR = MODELS_DIR / "stonkgs"
LOG_DIR = HOME / "logs"

EMBEDDINGS_PATH = KG_HPO_DIR / "embeddings_best_model.tsv"
RANDOM_WALKS_PATH = KG_HPO_DIR / "random_walks_best_model.tsv"
TRANSE_EMBEDDINGS_PATH = KG_HPO_DIR / "transe_embeddings_best_model.tsv"
PROT_EMBEDDINGS_PATH = KG_HPO_DIR / "embeddings_prot_best_model.tsv"
PROT_RANDOM_WALKS_PATH = KG_HPO_DIR / "random_walks_prot_best_model.tsv"

# environment configuration (dotenv-loaded, as the reference)
MLFLOW_TRACKING_URI = os.getenv("MLFLOW_TRACKING_URI")
MLFLOW_FINETUNING_TRACKING_URI = os.getenv("MLFLOW_FINETUNING_TRACKING_URI")
LOCAL_EXECUTION = os.getenv("LOCAL_EXECUTION", "True")

# backbone model ids
NLP_MODEL_TYPE = "dmis-lab/biobert-v1.1"
PROTSTONKGS_MODEL_TYPE = "google/bigbird-roberta-base"
PROT_SEQ_MODEL_TYPE = "Rostlab/prot_bert"

# the published artifacts
VOCAB_URL = "https://huggingface.co/dmis-lab/biobert-v1.1/raw/main/vocab.txt"
WALKS_URL = "https://zenodo.org/record/5205687/files/random_walks_best_model.tsv"
EMBEDDINGS_URL = "https://zenodo.org/record/5205687/files/embeddings_best_model.tsv"

# the published pre-trained checkpoints on the HF hub
DEFAULT_PRETRAINED_MODEL = "stonkgs/stonkgs-150k"
PRETRAINED_300K_MODEL = "stonkgs/stonkgs-300k"
DEFAULT_PROTSTONKGS_MODEL = "stonkgs/protstonkgs"


def ensure_dirs() -> None:
    """Create the directory tree (the reference does this at import)."""
    for d in (DATA_DIR, RAW_DIR, INPUT_DIR, OUTPUT_DIR, MISC_DIR,
              CORRECT_DIR, DISEASE_DIR, LOCATION_DIR, CELL_LINE_DIR,
              CELL_TYPE_DIR, ORGAN_DIR, SPECIES_DIR, RELATION_TYPE_DIR,
              PRETRAINING_DIR, MODELS_DIR, KG_HPO_DIR,
              STONKGS_PRETRAINING_DIR, PROTSTONKGS_PRETRAINING_DIR,
              TRANSESTONKGS_PRETRAINING_DIR, STONKGS_OUTPUT_DIR, LOG_DIR):
        d.mkdir(parents=True, exist_ok=True)
