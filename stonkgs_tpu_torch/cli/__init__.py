"""Command line interface of :mod:`stonkgs_tpu_torch`.

The port of the JAX package's click group (``stonkgs_tpu/cli/__init__.py``)
on ``argparse``: the same commands (``pretrain``, ``finetune``,
``finetune-all``, ``node2vec``, ``node2vec-hpo``, ``preprocess``,
``extract``, ``embed``, ``verify-parity``), the same option names and
defaults, the same printed lines, and ``--version``.  A machine that
serves the port needs no click: click's boolean pairs
(``--fsdp/--no-fsdp``) are ``argparse.BooleanOptionalAction``.

Each command that computes takes ``--device`` (``cuda`` by default), the
part ``JAX_PLATFORMS`` plays for the JAX CLI: ``--device cpu`` runs on the
CPU, and ``--device cuda`` without a card is refused with an error, never
run on the CPU.  ``--remat`` and ``--attention`` keep the JAX choices;
every ``--attention`` trains through the port's flash kernels.

Run it as ``python -m stonkgs_tpu_torch <command> ...`` or through the
``stonkgs-tpu-torch`` console script.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

__all__ = ["build_parser", "main"]

PROG = "stonkgs-tpu-torch"


def _device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the command computes: cuda (the card) or cpu")


def _kg_files(p: argparse.ArgumentParser) -> None:
    p.add_argument("--kg-embedding-path", required=True, type=str)
    p.add_argument("--kg-walks-path", required=True, type=str)


def _finetune_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("-e", "--epochs", default=5, type=int)
    p.add_argument("--cv", default=5, type=int)
    p.add_argument("--lr", default=5e-5, type=float)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--max_dataset_size", default=100000, type=int)
    p.add_argument("--output_dir", default="stonkgs-finetuning", type=str)


def build_parser() -> argparse.ArgumentParser:
    """The parser of every command: a subparser each, its options those of
    the JAX package's click command with the same names and defaults."""
    parser = argparse.ArgumentParser(prog=PROG,
                                     description="STonKGs on PyTorch and CUDA: the CLI.")
    parser.add_argument("--version", action="version", version=f"{PROG} (dev)")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")

    p = sub.add_parser("pretrain", help="Run STonKGs pre-training.")
    p.add_argument("--dataset", dest="dataset_path", required=True,
                   help="Preprocessed pre-training features (.pkl or .tsv)")
    p.add_argument("--variant", choices=["stonkgs", "transe", "prot"], default="stonkgs")
    p.add_argument("--kg-embedding-path", default=None,
                   help="node2vec embeddings TSV (builds the KG backbone)")
    p.add_argument("--lm-checkpoint", default=None,
                   help="HF BioBERT checkpoint dir for the frozen backbone")
    p.add_argument("--vocab-file", default=None,
                   help="tokenizer vocab.txt (sets the text vocab size)")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--max_steps", default=200, type=int)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--save_steps", default=5000, type=int)
    p.add_argument("--save_total_limit", default=5, type=int)
    p.add_argument("--output_dir", default="stonkgs-pretraining", type=str)
    p.add_argument("--n_model_shards", default=1, type=int,
                   help="model-axis size (shards KG table + decoders)")
    p.add_argument("--compute_dtype", default="bfloat16", type=str)
    p.add_argument("--remat", default="auto", choices=["auto", "none", "full", "attention"],
                   help="trunk rematerialization: full layers, attention-only (selective), "
                        "or none; auto = none (the flash kernels recompute their own "
                        "intermediates)")
    p.add_argument("--attention", dest="attention_impl", default="auto",
                   choices=["auto", "xla", "flash"],
                   help="attention implementation; every choice trains through the "
                        "port's flash kernels with in-kernel dropout")
    p.add_argument("--export_hf_dir", default=None, type=str,
                   help="export the final model as an HF checkpoint directory")
    p.add_argument("--frozen_bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="store the frozen backbones in bf16 (halves their memory)")
    p.add_argument("--fsdp", action=argparse.BooleanOptionalAction, default=False,
                   help="fully shard params/grads/optimizer over the data axis "
                        "(ZeRO-3 equivalent; needs several ranks)")
    p.add_argument("--log_steps", default=100, type=int)
    p.add_argument("--num_hidden_layers", default=None, type=int,
                   help="override trunk depth (smoke runs; default 12 at h=768)")
    p.add_argument("--local_rank", default=-1, type=int, help="THIS PARAMETER IS IGNORED")
    _device(p)
    p.set_defaults(run=_pretrain)

    p = sub.add_parser("finetune", help="Cross-validated fine-tuning on one task TSV.")
    p.add_argument("--train_data_path", required=True, type=str)
    p.add_argument("--model_path", required=True, help="Pretrained checkpoint dir")
    _kg_files(p)
    p.add_argument("--vocab-file", required=True, type=str)
    p.add_argument("--class_column_name", default="class", type=str)
    _finetune_options(p)
    p.add_argument("--task_name", default="", type=str)
    _device(p)
    p.set_defaults(run=_finetune)

    p = sub.add_parser("finetune-all", help="Run the full 10-task fine-tuning battery.")
    p.add_argument("--input_dir", required=True,
                   help="directory with the per-task *_ppi_prot.tsv files")
    p.add_argument("--model_path", required=True, type=str)
    _kg_files(p)
    p.add_argument("--vocab-file", required=True, type=str)
    _finetune_options(p)
    _device(p)
    p.set_defaults(run=_finetune_all)

    p = sub.add_parser("node2vec", help="Train node2vec KG embeddings.")
    p.add_argument("--pretraining_path", required=True, type=str)
    p.add_argument("--sep", default="\t", type=str)
    p.add_argument("--n_threads", default=None, type=int)
    p.add_argument("--dimensions", default=768, type=int)
    p.add_argument("--walk_length", default=127, type=int)
    p.add_argument("--epochs", default=4, type=int)
    p.add_argument("--window_size", default=3, type=int)
    p.add_argument("--embeddings_output_path", default=None, type=str)
    p.add_argument("--random_walks_output_path", default=None, type=str)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--device_pipeline", action="store_true", default=False,
                   help="fully on-device SGNS stage (no host pair feed)")
    _device(p)
    p.set_defaults(run=_node2vec)

    p = sub.add_parser("node2vec-hpo", help="node2vec HPO via link prediction.")
    p.add_argument("--pretraining_path", required=True, type=str)
    p.add_argument("--n_trials", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--output_dir", default=".", type=str)
    _device(p)
    p.set_defaults(run=_node2vec_hpo)

    p = sub.add_parser("preprocess", help="Preprocess pre-training triples into features.")
    p.add_argument("--pretraining_path", required=True,
                   help="pretraining_triples.tsv (source/target/evidence columns)")
    _kg_files(p)
    p.add_argument("--vocab-file", required=True, type=str)
    p.add_argument("--variant", choices=["stonkgs", "transe"], default="stonkgs")
    p.add_argument("--nsp_negative_proportion", default=0.25, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--output", dest="output_path", required=True,
                   help="output .pkl of preprocessed features")
    p.set_defaults(run=_preprocess)

    p = sub.add_parser("extract", help="Extract the INDRA KG into task TSVs.")
    p.add_argument("--path", required=True, help="INDRA statements JSON-lines")
    p.add_argument("--output_dir", required=True, type=str)
    p.set_defaults(run=_extract)

    p = sub.add_parser("embed", help="Extract pooled embeddings for text-triple pairs.")
    p.add_argument("--input", dest="input_path", required=True,
                   help="TSV with source/target/evidence columns")
    p.add_argument("--model_path", required=True, type=str)
    _kg_files(p)
    p.add_argument("--vocab-file", required=True, type=str)
    p.add_argument("--output", dest="output_path", required=True, type=str)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--no-masking", action="store_true", default=False,
                   help="disable the reference's inference-time masking quirk")
    _device(p)
    p.set_defaults(run=_embed)

    p = sub.add_parser("verify-parity",
                       help="Compare the port against a transformers execution of a "
                            "checkpoint.")
    p.add_argument("--model_path", required=True, type=str)
    _kg_files(p)
    p.add_argument("--n_rows", default=8, type=int)
    p.add_argument("--tolerance", default=1e-5, type=float)
    _device(p)
    p.set_defaults(run=_verify_parity)
    return parser


def _options(args: argparse.Namespace) -> dict:
    return {k: v for k, v in vars(args).items() if k not in ("command", "run")}


def _pretrain(args) -> int:
    from stonkgs_tpu_torch.cli.pretrain import run_pretraining

    run_pretraining(**_options(args))
    return 0


def _finetune(args) -> int:
    from stonkgs_tpu_torch.cli.finetune import run_finetuning

    run_finetuning(**_options(args))
    return 0


def _finetune_all(args) -> int:
    from stonkgs_tpu_torch.cli.finetune import run_all_fine_tuning_tasks

    results = run_all_fine_tuning_tasks(**_options(args))
    for task, res in results.items():
        print(f"{task}: f1 {res['f1_score_mean']:.4f} ± {res['f1_score_std']:.4f}")
    return 0


def _node2vec(args) -> int:
    from stonkgs_tpu_torch.models.node2vec import run_node2vec

    run_node2vec(**_options(args))
    return 0


def _node2vec_hpo(args) -> int:
    from stonkgs_tpu_torch.models.node2vec import run_node2vec_hpo

    print(str(run_node2vec_hpo(**_options(args))))
    return 0


def _preprocess(args) -> int:
    """Pre-training triples -> a pickle of features that ``pretrain``
    reads.  The TSV is read with the port's reader (names kept as the
    file spells them); pandas writes the pickle."""
    import pandas as pd

    from stonkgs_tpu_torch.data.fast_tokenizer import FastBertTokenizer
    from stonkgs_tpu_torch.data.tsv_io import read_columns

    tokenizer = FastBertTokenizer(args.vocab_file)
    if args.variant == "transe":
        from stonkgs_tpu_torch.data.transe import (
            load_transe_artifacts,
            preprocess_transe_for_pretraining,
        )

        cols = read_columns(args.pretraining_path, ("source", "relation", "target", "evidence"))
        artifacts = load_transe_artifacts(args.kg_embedding_path)
        feats, skips = preprocess_transe_for_pretraining(
            cols["source"], cols["relation"], cols["target"], cols["evidence"],
            artifacts, tokenizer,
            nsp_negative_proportion=args.nsp_negative_proportion, seed=args.seed)
        print(f"{skips} many examples were skipped")
    else:
        import numpy as np

        from stonkgs_tpu_torch.data.artifacts import load_kg_artifacts
        from stonkgs_tpu_torch.data.preprocessing import preprocess_for_pretraining

        cols = read_columns(args.pretraining_path, ("source", "target", "evidence"))
        artifacts = load_kg_artifacts(args.kg_embedding_path, args.kg_walks_path)
        feats = preprocess_for_pretraining(
            np.asarray(cols["source"], object), np.asarray(cols["target"], object),
            cols["evidence"], artifacts, tokenizer,
            nsp_negative_proportion=args.nsp_negative_proportion, seed=args.seed)
    pd.DataFrame({k: list(v) for k, v in feats.items()}).to_pickle(args.output_path)
    print(f"wrote {len(feats['input_ids'])} examples to {args.output_path}")
    return 0


def _extract(args) -> int:
    from stonkgs_tpu_torch.data.indra_extraction import read_indra_triples

    for k, v in read_indra_triples(args.path, args.output_dir).items():
        print(f"{k}: {v}")
    return 0


def _embed(args) -> int:
    """Rows of a TSV -> pooled embeddings, written as a one-column TSV
    (each embedding a list), the bytes pandas writes."""
    import numpy as np

    from stonkgs_tpu_torch.api.inference import STonKGsEngine
    from stonkgs_tpu_torch.data.tsv_io import read_columns, write_table

    cols = read_columns(args.input_path, ("source", "target", "evidence"))
    engine = STonKGsEngine.from_pretrained(
        args.model_path, args.kg_embedding_path, args.kg_walks_path,
        vocab_file=args.vocab_file, batch_size=args.batch_size, device=args.device)
    feats = engine.preprocess(
        np.asarray(cols["source"], object), np.asarray(cols["target"], object),
        cols["evidence"], apply_masking=not args.no_masking)
    emb = engine.embed(feats)
    write_table(args.output_path, {"embedding": [row.tolist() for row in emb]})
    print(f"wrote {len(emb)} embeddings to {args.output_path}")
    return 0


def _verify_parity(args) -> int:
    from stonkgs_tpu_torch.utils.parity import verify_parity

    report = verify_parity(args.model_path, args.kg_embedding_path, args.kg_walks_path,
                           n_rows=args.n_rows, device=args.device)
    print(report.summary(args.tolerance))
    return 1 if report.max_dev >= args.tolerance else 0


def main(argv: Optional[List[str]] = None) -> int:
    """Parse ``argv`` (the process's arguments by default), run the
    command, and return its exit code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    device = getattr(args, "device", None)
    if device is not None:
        import torch

        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            parser.error(f"--device {device}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
