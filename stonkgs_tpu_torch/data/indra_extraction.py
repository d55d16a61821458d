"""INDRA statements -> BEL-style knowledge graph -> task TSVs.

The port's copy of the JAX package's ``data/indra_extraction.py`` (the
reference's ``indra_extraction.py`` without pybel or indra):

* the statement half: the BEL relation constants, agent grounding, BEL
  node names (``p(HGNC:391 ! AKT1)``, the strings the node2vec artifacts
  and preprocessors key on) and :func:`statement_edges`, which turns one
  INDRA statement's JSON into its edges, one per evidence; statement
  types map to relations as pybel's INDRA importer maps them;
* the graph half, from :func:`from_indra_statements` to
  :func:`read_indra_triples`: the multigraph, the removal of ungrounded
  nodes, the largest connected component, the KG summary JSON, the four
  context tasks, the polarity / interaction task, and the pre-training
  triples without the fine-tuning edges.

No networkx and no pandas: the graph is
:class:`~stonkgs_tpu_torch.data.kg_graph.MultiDiGraph` (networkx's orders
and keys) and the TSVs are written by
:func:`~stonkgs_tpu_torch.data.tsv_io.write_records`, so every file is
the JAX package's byte for byte.
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Tuple

from stonkgs_tpu_torch.data.kg_graph import MultiDiGraph
from stonkgs_tpu_torch.data.tsv_io import write_records

logger = logging.getLogger(__name__)

# BEL relation constants (pybel.constants values)
INCREASES = "increases"
DIRECTLY_INCREASES = "directlyIncreases"
DECREASES = "decreases"
DIRECTLY_DECREASES = "directlyDecreases"
REGULATES = "regulates"
BINDS = "binds"
CORRELATION = "correlation"
NO_CORRELATION = "noCorrelation"
NEGATIVE_CORRELATION = "negativeCorrelation"
POSITIVE_CORRELATION = "positiveCorrelation"
ASSOCIATION = "association"
PART_OF = "partOf"

DIRECT_RELATIONS = {DIRECTLY_INCREASES, DIRECTLY_DECREASES, BINDS}
INDIRECT_RELATIONS = {
    REGULATES, CORRELATION, DECREASES, INCREASES, NO_CORRELATION,
    NEGATIVE_CORRELATION, POSITIVE_CORRELATION, ASSOCIATION, PART_OF,
}
UP_RELATIONS = {INCREASES, POSITIVE_CORRELATION, DIRECTLY_INCREASES}
DOWN_RELATIONS = {DECREASES, NEGATIVE_CORRELATION, DIRECTLY_DECREASES}

# grounding namespace priority (INDRA default_ns_order)
_NS_PRIORITY = ["FPLX", "HGNC", "UP", "UPPRO", "GO", "MESH", "CHEBI",
                "MIRBASE", "EFO", "DOID", "HP", "PUBCHEM"]

# agent namespace -> BEL function
_CHEMICAL_NS = {"CHEBI", "PUBCHEM"}
_PROCESS_NS = {"GO", "MESH", "EFO", "DOID", "HP"}

# INDRA statement type -> (relation, is_modification)
_STMT_RELATION = {
    "Activation": INCREASES,
    "IncreaseAmount": INCREASES,
    "Inhibition": DECREASES,
    "DecreaseAmount": DECREASES,
    "Association": ASSOCIATION,
    "RegulateAmount": REGULATES,
    "RegulateActivity": REGULATES,
    "Influence": REGULATES,
}
# modifications map to directlyIncreases/decreases (pybel INDRA importer)
_MODIFICATIONS = {
    "Phosphorylation", "Dephosphorylation", "Ubiquitination",
    "Deubiquitination", "Acetylation", "Deacetylation", "Methylation",
    "Demethylation", "Hydroxylation", "Sumoylation", "Glycosylation",
    "Ribosylation", "Farnesylation", "Palmitoylation", "Myristoylation",
    "Autophosphorylation",
}
_REMOVING_MODS = {"Dephosphorylation", "Deubiquitination", "Deacetylation",
                  "Demethylation"}

CONTEXT_KEYS = ("species", "cell_line", "disease", "location", "organ",
                "cell_type")


# ---------------------------------------------------------------------------
# agents -> BEL node names
# ---------------------------------------------------------------------------

def ground_agent(agent: dict) -> Tuple[str, str, str]:
    """Agent dict -> (namespace, identifier, name)."""
    db_refs = agent.get("db_refs", {}) or {}
    name = agent.get("name", "")
    for ns in _NS_PRIORITY:
        if ns in db_refs:
            return ns, str(db_refs[ns]), name
    return "TEXT", str(db_refs.get("TEXT", name)), name


def agent_node(agent: dict) -> Tuple[str, dict]:
    """Agent -> (BEL node name, node attributes)."""
    ns, ident, name = ground_agent(agent)
    if ns in _CHEMICAL_NS:
        func = "a"
        kind = "abundance"
    elif ns in _PROCESS_NS:
        func = "a"
        kind = "abundance"
    elif ns == "MIRBASE":
        func = "m"
        kind = "mirna"
    else:
        func = "p"
        kind = "protein"
    curie = f"{ns}:{ident}"
    label = f"{func}({curie} ! {name})" if name else f"{func}({curie})"
    return label, {"kind": kind, "curie": curie, "grounded": ns != "TEXT",
                   "members": ()}


def complex_node(members: List[Tuple[str, dict]]) -> Tuple[str, dict]:
    """BEL complex node string for a members list (sorted, deduped)."""
    names = sorted(m[0] for m in members)
    label = "complex(" + ", ".join(names) + ")"
    grounded_members = tuple(m[0] for m in members)
    return label, {
        "kind": "complex", "curie": "",
        "grounded": all(m[1]["grounded"] for m in members),
        "members": grounded_members,
    }


# ---------------------------------------------------------------------------
# statements -> edges
# ---------------------------------------------------------------------------

def _evidence_fields(stmt: dict) -> Iterable[Tuple[str, str, dict]]:
    """Yield (text, pmid, annotations) per evidence (one edge per evidence)."""
    for ev in stmt.get("evidence", []) or [{}]:
        text = ev.get("text") or ""
        pmid = ev.get("pmid") or ""
        annotations: Dict[str, Any] = {}
        context = ev.get("context") or {}
        for key in CONTEXT_KEYS:
            val = context.get(key)
            if isinstance(val, dict):
                val = val.get("name") or val.get("db_refs", {}).get("TEXT")
            if val:
                annotations[key] = {str(val): True}
        if "annotations" in ev and isinstance(ev["annotations"], dict):
            for key in CONTEXT_KEYS:
                if key in ev["annotations"] and key not in annotations:
                    annotations[key] = {str(ev["annotations"][key]): True}
        yield text, pmid, annotations


def statement_edges(stmt: dict) -> List[Tuple[Tuple[str, dict], str, Tuple[str, dict], dict]]:
    """One INDRA statement -> list of (u_node, relation, v_node, data)."""
    stype = stmt.get("type")
    belief = stmt.get("belief", "")
    out = []

    def emit(u, rel, v):
        for text, pmid, annotations in _evidence_fields(stmt):
            annotations = dict(annotations)
            annotations["belief"] = belief
            out.append((u, rel, v, {
                "relation": rel, "evidence": text, "citation": pmid,
                "annotations": annotations,
            }))

    if stype in _STMT_RELATION:
        subj = stmt.get("subj") or stmt.get("agent")
        obj = stmt.get("obj")
        if not subj or not obj:
            return []
        emit(agent_node(subj), _STMT_RELATION[stype], agent_node(obj))
    elif stype in _MODIFICATIONS:
        enz = stmt.get("enz")
        sub = stmt.get("sub")
        if not enz or not sub:
            return []
        rel = DIRECTLY_DECREASES if stype in _REMOVING_MODS else DIRECTLY_INCREASES
        emit(agent_node(enz), rel, agent_node(sub))
    elif stype == "Complex":
        members = [agent_node(m) for m in stmt.get("members", []) if m]
        if len(members) < 2:
            return []
        cplx = complex_node(members)
        for m in members:
            emit(m, PART_OF, cplx)
    elif stype in ("Gef", "Gap"):
        subj = stmt.get("gef") or stmt.get("gap")
        obj = stmt.get("ras")
        if not subj or not obj:
            return []
        rel = INCREASES if stype == "Gef" else DECREASES
        emit(agent_node(subj), rel, agent_node(obj))
    elif stype == "Conversion":
        subj = stmt.get("subj")
        if not subj:
            return []
        for prod in stmt.get("obj_to", []) or []:
            emit(agent_node(subj), INCREASES, agent_node(prod))
        for reac in stmt.get("obj_from", []) or []:
            emit(agent_node(subj), DECREASES, agent_node(reac))
    # other statement types (ActiveForm, Translocation, SelfModification
    # without both agents, ...) contribute no binary edges, like pybel
    return out


def from_indra_statements(
    statements: Iterable[dict], into: Optional[MultiDiGraph] = None
) -> MultiDiGraph:
    """INDRA statement dicts -> BEL-style multigraph.

    ``into`` extends an existing graph in place (chunked corpus reads)."""
    g = MultiDiGraph() if into is None else into
    for stmt in statements:
        for (u_name, u_attrs), rel, (v_name, v_attrs), data in statement_edges(stmt):
            if u_name not in g:
                g.add_node(u_name, **u_attrs)
            if v_name not in g:
                g.add_node(v_name, **v_attrs)
            g.add_edge(u_name, v_name, **data)
    return g


# ---------------------------------------------------------------------------
# graph hygiene + task dumps (reference behavior)
# ---------------------------------------------------------------------------

def remove_ungrounded_nodes(g: MultiDiGraph) -> int:
    """Drop TEXT:-grounded nodes and complexes with ungrounded members."""
    bad = {n for n, d in g.nodes(data=True) if not d.get("grounded", True)}
    for n, d in g.nodes(data=True):
        for member in d.get("members", ()):
            if member in bad or (member in g
                                 and not g.node_attrs(member).get("grounded", True)):
                bad.add(n)
    g.remove_nodes_from(bad)
    return len(bad)


def keep_largest_component(g: MultiDiGraph) -> int:
    """Restrict the graph to its largest weakly connected component (the
    first discovered among equal ones)."""
    comps = sorted(g.connected_components(), key=len, reverse=True)
    if not comps:
        return 0
    drop = [n for comp in comps[1:] for n in comp]
    g.remove_nodes_from(drop)
    return len(drop)


def _has_evidence(data: dict) -> bool:
    ev = data.get("evidence")
    return bool(ev) and ev != "No evidence text."


def create_context_type_specific_subgraph(
    g: MultiDiGraph, context_annotations: List[str]
) -> Tuple[List, MultiDiGraph]:
    """Edges carrying any of the annotations -> (edges_to_remove, subgraph)."""
    sub = MultiDiGraph()
    edges_to_remove = []
    for u, v, k, data in g.edges(keys=True, data=True):
        ann = data.get("annotations", {})
        if any(a in ann for a in context_annotations):
            sub.add_edge(u, v, k, **data)
            edges_to_remove.append((u, v, k))
    logger.info(
        "subgraph %s: %d nodes %d edges", context_annotations,
        sub.number_of_nodes(), sub.number_of_edges())
    return edges_to_remove, sub


def _value_counts(values: list) -> Dict[Any, int]:
    """``Series(values).value_counts().to_dict()``: by count, descending,
    ties in order of first appearance."""
    counts = Counter(values)
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def dump_edgelist(g: MultiDiGraph, annotations: List[str], name: str,
                  output_dir: str) -> Dict[str, Any]:
    """Per-task TSV: one row per (edge, annotation value); multi-label
    triples for the same annotation are skipped (reference ``:299-302``)."""
    triples = []
    for u, v, data in g.edges(data=True):
        if not _has_evidence(data):
            continue
        for annotation, values in data.get("annotations", {}).items():
            if annotation not in annotations:
                continue
            if isinstance(values, dict) and len(values) > 1:
                logger.warning("triple has more than one label -> %s", values)
                continue
            vals = list(values) if isinstance(values, dict) else [values]
            for label in vals:
                triples.append({
                    "source": u, "relation": data["relation"], "target": v,
                    "evidence": data["evidence"], "pmid": data["citation"],
                    "class": label,
                })
    if not triples:
        return {"context": name, "number_of_triples": "0",
                "number_of_labels": "0", "labels": "0"}
    os.makedirs(output_dir, exist_ok=True)
    write_records(os.path.join(output_dir, f"{name}.tsv"), triples)
    labels = _value_counts([t["class"] for t in triples])
    return {
        "context": name,
        "number_of_triples": len(triples),
        "number_of_labels": len(labels),
        "labels": labels,
    }


def binarize_triple_direction(
    g: MultiDiGraph, output_dir: str, triples_per_class: int = 25000
) -> Tuple[Dict[str, Any], List]:
    """Polarity (up/down) + interaction (direct/indirect) task TSV.

    Only protein/gene endpoint triples; 25k cap per relation class
    (reference ``:83-172``; note the reference requires only ONE endpoint
    to be CentralDogma — ``not isinstance(u, CD) and not isinstance(v, CD)``
    skips — replicated)."""
    triples, edges_to_remove = [], []
    counters = Counter()
    for u, v, k, data in g.edges(keys=True, data=True):
        if not _has_evidence(data):
            continue
        u_protein = g.node_attrs(u).get("kind") == "protein"
        v_protein = g.node_attrs(v).get("kind") == "protein"
        if not u_protein and not v_protein:
            continue
        rel = data["relation"]
        if rel in UP_RELATIONS:
            polarity = "up"
        elif rel in DOWN_RELATIONS:
            polarity = "down"
        else:
            continue
        if rel in (INCREASES, DECREASES):
            interaction = "indirect_interaction"
        elif rel in (DIRECTLY_INCREASES, DIRECTLY_DECREASES):
            interaction = "direct_interaction"
        else:
            continue
        if counters[rel] >= triples_per_class:
            continue
        counters[rel] += 1
        triples.append({
            "source": u, "relation": rel, "target": v,
            "evidence": data["evidence"], "pmid": data["citation"],
            "polarity": polarity, "interaction": interaction,
        })
        edges_to_remove.append((u, v, k))

    logger.info("Number of binarized triples for fine-tuning: %d", len(triples))
    os.makedirs(output_dir, exist_ok=True)
    write_records(os.path.join(output_dir, "relation_type.tsv"), triples)
    summary = {"context": "(in)direct relations and polarity",
               "number_of_triples": len(triples),
               "number_of_labels": "4 or 2 depending on the task",
               "labels": "NA"}
    return summary, edges_to_remove


def munge_evidence_text(text: str) -> str:
    """Strip XREF_BIBR citation markers (reference ``:358-368``)."""
    if "XREF_BIBR" in text:
        text = text.replace("XREF_BIBR, ", "")
        text = text.replace("XREF_BIBR,", "")
        text = text.replace("XREF_BIBR", "")
        text = text.replace("[", "")
        text = text.replace("]", "")
    return text


TASKS = ("species", "disease", "cell_line", "location")


def read_indra_triples(
    path: str,
    output_dir: str,
    *,
    batch_size: int = 10_000_000,
    triples_per_class: int = 25000,
) -> Dict[str, str]:
    """Full extraction pipeline; returns the written file paths (a
    context task without rows writes no file).

    ``batch_size`` bounds peak memory: statement JSON is parsed and folded
    into the graph in chunks of that many lines instead of materializing
    the whole ~35M-line corpus (the reference's optional chunked union,
    ``indra_extraction.py:396-418``)."""
    g = MultiDiGraph()
    n_errors = n_lines = 0
    chunk = []
    with open(path) as f:
        for n_lines, line in enumerate(f, 1):
            try:
                chunk.append(json.loads(line))
            except json.JSONDecodeError:
                n_errors += 1
            if len(chunk) >= batch_size:
                from_indra_statements(chunk, into=g)
                chunk = []
    from_indra_statements(chunk, into=g)
    del chunk
    logger.info("%d statements with errors from %d lines", n_errors, n_lines)
    n_removed = remove_ungrounded_nodes(g)
    logger.warning("removing %d non grounded nodes", n_removed)
    n_dropped = keep_largest_component(g)
    logger.warning("%d nodes were removed (not in largest component)", n_dropped)

    misc_dir = os.path.join(output_dir, "misc")
    os.makedirs(misc_dir, exist_ok=True)
    summary = {
        "node_summary": dict(Counter(
            d.get("curie", "").split(":")[0] for _, d in g.nodes(data=True))),
        "relation_summary": dict(Counter(
            d["relation"] for _, _, d in g.edges(data=True))),
        "functions_summary": dict(Counter(
            d.get("kind", "") for _, d in g.nodes(data=True))),
        "annotations_summary": dict(Counter(
            key for _, _, d in g.edges(data=True)
            for key in d.get("annotations", {}))),
    }
    with open(os.path.join(misc_dir, "indra_kg_overview_summary.json"), "w") as f:
        json.dump([{"name": k, "value": v} for k, v in summary.items()], f,
                  ensure_ascii=False)

    task_dirs = {name: os.path.join(output_dir, name)
                 for name in TASKS + ("relation_type",)}
    summaries, removals = [], []
    for name in TASKS:
        edges, sub = create_context_type_specific_subgraph(g, [name])
        removals.append(edges)
        summaries.append(dump_edgelist(sub, [name], name, task_dirs[name]))
    polarity_summary, polarity_edges = binarize_triple_direction(
        g, task_dirs["relation_type"], triples_per_class)
    removals.append(polarity_edges)
    summaries.append(polarity_summary)
    write_records(os.path.join(misc_dir, "summary.tsv"), summaries)

    for edges in removals:
        g.remove_edges_from(edges)

    triples = []
    for u, v, data in g.edges(data=True):
        if not _has_evidence(data):
            continue
        triples.append({
            "source": u, "relation": data["relation"], "target": v,
            "evidence": munge_evidence_text(data["evidence"]),
            "pmid": data["citation"],
            "belief_score": data.get("annotations", {}).get("belief", ""),
        })
    pretraining_dir = os.path.join(output_dir, "pretraining")
    os.makedirs(pretraining_dir, exist_ok=True)
    pretraining_path = os.path.join(pretraining_dir, "pretraining_triples.tsv")
    write_records(pretraining_path, triples)
    return {"pretraining": pretraining_path,
            **{k: os.path.join(v, f"{k}.tsv") for k, v in task_dirs.items()}}
