"""Add protein sequences to text-triple pairs (ProtSTonKGs data prep).

The port's copy of the JAX package's ``data/protein_sequences.py`` (the
reference's ``add_protein_sequences.py``): for each text-triple row with
Entrez ids, resolve the UniProt id and fetch the protein sequence; rows
where either endpoint lacks a sequence are dropped.  Chunked
append-to-TSV with resume-by-last-row (reference ``:38-56``), byte for
byte as the JAX package writes it (pandas, imported inside the function
that reads the task TSV).

The Entrez->UniProt->sequence resolver is pluggable: protmapper when
installed (the reference's backend, which needs the network), otherwise
a caller-provided mapping (e.g. from a local UniProt dump), which keeps
this step functional offline.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional


logger = logging.getLogger(__name__)

SequenceLookup = Callable[[str], Optional[str]]


def protmapper_lookup() -> SequenceLookup:
    """Sequence lookup via protmapper (requires network + dependency)."""
    from protmapper.uniprot_client import get_id_from_entrez, get_sequence

    def lookup(entrez_id: str) -> Optional[str]:
        uniprot = get_id_from_entrez(str(entrez_id))
        if uniprot is None:
            return None
        return get_sequence(uniprot.split(",")[0])

    return lookup


def dict_lookup(mapping: dict) -> SequenceLookup:
    """Sequence lookup from a local {entrez_id: sequence} mapping."""
    return lambda entrez_id: mapping.get(str(entrez_id))


def add_protein_sequences_per_task(
    input_file: str,
    output_file: str,
    *,
    lookup: Optional[SequenceLookup] = None,
    chunk_size: int = 10_000,
) -> int:
    """Append ``source_prot``/``target_prot`` columns; returns kept rows."""
    import os

    import pandas as pd

    if lookup is None:
        lookup = protmapper_lookup()

    input_df = pd.read_csv(input_file, sep="\t", index_col=None)
    begin_cn = 0
    header_written = False
    if os.path.exists(output_file):
        if os.path.getsize(output_file) == 0:
            os.remove(output_file)  # stale empty file: start fresh
        else:
            header_written = True
            result_df = pd.read_csv(output_file, sep="\t", index_col=None)
            if len(result_df):
                last = result_df.iloc[-1][["source_id", "target_id", "evidence"]]
                match = input_df.index[
                    (input_df["source_id"] == last["source_id"])
                    & (input_df["target_id"] == last["target_id"])
                    & (input_df["evidence"] == last["evidence"])
                ]
                if len(match):
                    begin_cn = int(match[0] // chunk_size) + 1
                    logger.info("resuming from batch %d", begin_cn)

    cn = len(input_df) // chunk_size + 1
    for i in range(begin_cn, cn):
        chunk = input_df.iloc[
            chunk_size * i: min(chunk_size * (i + 1), len(input_df))]
        rows = []
        for _, row in chunk.iterrows():
            source_prot = lookup(str(row["source_id"]))
            target_prot = lookup(str(row["target_id"]))
            if source_prot is None or target_prot is None:
                continue
            out = dict(row)
            out["source_prot"] = source_prot
            out["target_prot"] = target_prot
            rows.append(out)
        partial = pd.DataFrame(
            rows, columns=list(input_df.columns) + ["source_prot", "target_prot"])
        partial.to_csv(output_file, sep="\t", index=False, mode="a",
                       header=not header_written)
        header_written = True

    result_df = pd.read_csv(output_file, sep="\t", index_col=None)
    logger.info("%d/%d text-triple pairs have protein sequences for both nodes",
                len(result_df), len(input_df))
    return len(result_df)
