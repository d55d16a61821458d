"""A whole example of a published fine-tuned model in use.

Run with ``python -m stonkgs_tpu_torch.api.example`` (the port of the JAX
package's ``stonkgs_tpu/api/example.py``, the reference's
``api/example.py``): the species model over the README's three rows, the
predictions written to a TSV under ``STONKGS_TPU_HOME``.  The model runs
on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from stonkgs_tpu_torch.constants import HOME

SPECIES_PREDICTION_PATH = HOME / "species" / "predictions.tsv"

EXAMPLE_ROWS = [
    [
        "p(HGNC:1748 ! CDH1)",
        "p(HGNC:2515 ! CTNND1)",
        "Some example sentence about CDH1 and CTNND1.",
    ],
    [
        "p(HGNC:6871 ! MAPK1)",
        "p(HGNC:6018 ! IL6)",
        "Another example about some interaction between MAPK and IL6.",
    ],
    [
        "p(HGNC:3229 ! EGF)",
        "p(HGNC:4066 ! GAB1)",
        "One last example in which Gab1 and EGF are mentioned.",
    ],
]


def main(device: str = "cuda"):
    """Apply the species model to the README's example rows."""
    import csv

    from stonkgs_tpu_torch.api import api

    SPECIES_PREDICTION_PATH.parent.mkdir(parents=True, exist_ok=True)
    rows = iter(api.infer_species(EXAMPLE_ROWS, device=device))
    with open(SPECIES_PREDICTION_PATH, "w") as f:
        writer = csv.writer(f, delimiter="\t")
        for row in rows:
            writer.writerow(row)
    print(f"Results at {SPECIES_PREDICTION_PATH}")

    # optional: a text-processing round trip through INDRA REACH, if installed
    try:
        from indra.sources import reach

        statements = reach.process_text("SENP1 desumoylates HIF1A").statements
        print(statements)
        print(list(api.infer_species(statements, device=device)))
    except ImportError:
        print("indra not installed; skipping REACH text-processing demo")


if __name__ == "__main__":
    main()
