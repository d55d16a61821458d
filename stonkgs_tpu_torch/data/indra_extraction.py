"""INDRA statements -> BEL-style edges: the statement half of the extraction.

The port's copy of the first half of the JAX package's
``data/indra_extraction.py`` (the reference's ``indra_extraction.py``
without pybel or indra): the BEL relation constants, agent grounding,
BEL node names (``p(HGNC:391 ! AKT1)``, the strings the node2vec
artifacts and preprocessors key on) and :func:`statement_edges`, which
turns one INDRA statement's JSON into its edges, one per evidence.
Statement types map to relations as pybel's INDRA importer maps them.
The graph half (networkx, the connected component, the task TSVs) is not
ported here.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

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
