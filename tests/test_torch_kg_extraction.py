"""The port's INDRA extraction, data preparation and baseline batteries
against the JAX package, on the CPU.

* the multigraph (``data/kg_graph.py``) against ``networkx.MultiDiGraph``
  on random sequences of adds and removals: nodes and their data, edges
  with keys and data in networkx's order, counts, and the undirected
  components in discovery order;
* ``read_indra_triples`` on ``tests/test_indra_extraction.py``'s
  statements and on seeded corpora of a few hundred statements (every
  statement type ``statement_edges`` handles, TEXT agents, complexes with
  an ungrounded member, two largest components of equal size, multi-edges,
  annotations for all four contexts in both spellings, XREF_BIBR
  evidence, tabs, quotes and line breaks in evidence, integer and missing
  beliefs and PMIDs, a relation cap, chunked reads, tasks without rows):
  every file byte-equal to the JAX package's;
* ``add_protein_sequences_per_task`` and ``transe_pretraining_to_tsv``
  byte-equal, fresh and resumed from a partial file;
* both batteries on task directories with one task missing: per task
  equal to calling the port's ``run_*_cv`` directly, and the features
  and labels each task hands to the CV equal to those of the JAX
  battery (its training draws on ``jax.random``, so the runs themselves
  are not matched step for step).
"""

import json
import os
import shutil

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.baselines import batteries as jbat
from stonkgs_tpu.baselines import kg_baseline as jkg
from stonkgs_tpu.baselines import nlp_baseline as jnlp
from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.data import indra_extraction as jext
from stonkgs_tpu.data import protein_sequences as jprot_seq
from stonkgs_tpu.data import transe as jtranse
from stonkgs_tpu.data.wordpiece import BertTokenizer as JaxBertTokenizer
from stonkgs_tpu_torch.baselines import batteries as tbat
from stonkgs_tpu_torch.baselines import kg_baseline as tkg
from stonkgs_tpu_torch.baselines import nlp_baseline as tnlp
from stonkgs_tpu_torch.config import BertConfig
from stonkgs_tpu_torch.data import artifacts as tart
from stonkgs_tpu_torch.data import indra_extraction as text
from stonkgs_tpu_torch.data import protein_sequences as tprot_seq
from stonkgs_tpu_torch.data import transe as ttranse
from stonkgs_tpu_torch.data.kg_graph import MultiDiGraph
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer

from test_indra_extraction import _statements
from test_torch_hf_io import WORDS, bert_vocab


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# the multigraph
# ---------------------------------------------------------------------------

def graph_state(g, ours: bool):
    comps = (g.connected_components() if ours
             else [sorted(c, key=list(g.nodes).index)
                   for c in nx.connected_components(g.to_undirected())])
    return (list(g.nodes(data=True)), list(g.edges(keys=True, data=True)),
            g.number_of_nodes(), g.number_of_edges(), [list(c) for c in comps])


@pytest.mark.parametrize("seed", range(6))
def test_multigraph_matches_networkx(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = MultiDiGraph(), nx.MultiDiGraph()
    names = [f"v{i}" for i in range(12)]
    for step in range(300):
        op = rng.random()
        u, v = (names[i] for i in rng.integers(0, len(names), 2))
        if op < 0.1:
            attrs = {"kind": str(rng.integers(3)), "step": step}
            ours.add_node(u, **attrs)
            theirs.add_node(u, **attrs)
        elif op < 0.7:
            key = None if rng.random() < 0.8 else int(rng.integers(0, 4))
            data = {"relation": str(rng.integers(4)), "step": step}
            assert ours.add_edge(u, v, key, **data) == theirs.add_edge(u, v, key, **data)
        elif op < 0.95:
            edges = list(theirs.edges(keys=True))
            bunch = [edges[i] for i in rng.integers(0, len(edges), 2)] if edges else []
            bunch.append((u, v, int(rng.integers(0, 3))))      # maybe missing
            ours.remove_edges_from(bunch)
            theirs.remove_edges_from(bunch)
        else:
            drop = [u, "absent"]
            ours.remove_nodes_from(drop)
            theirs.remove_nodes_from(drop)
        if step % 25 == 0 or step == 299:
            assert graph_state(ours, True) == graph_state(theirs, False)
    assert ours.number_of_edges() > 0


# ---------------------------------------------------------------------------
# read_indra_triples
# ---------------------------------------------------------------------------

NAMESPACES = ("HGNC", "FPLX", "UP", "UPPRO", "GO", "MESH", "CHEBI", "MIRBASE", "EFO", "DOID",
              "HP", "PUBCHEM")
WORDS_EV = ("alpha", "beta", "binds", "activates", "cells", "in", "the", "p53", "signal")
CELL_LINES = [f"line{i}" for i in range(20)]


def _agent(i, text=False):
    if text:
        return {"name": f"thing{i}", "db_refs": {"TEXT": f"thing{i}"}}
    return {"name": f"G{i}", "db_refs": {NAMESPACES[i % len(NAMESPACES)]: str(i),
                                         "TEXT": f"g{i}"}}


def _evidence(rng, k):
    words = [WORDS_EV[j] for j in rng.integers(0, len(WORDS_EV), rng.integers(3, 9))]
    text = " ".join(words) + "."
    r = rng.random()
    if r < 0.05:
        text += " [XREF_BIBR, XREF_BIBR]"
    elif r < 0.08:
        text = 'a "quoted"\tand tabbed ' + text
    elif r < 0.10:
        text = text + "\nsecond line"
    elif r < 0.12:
        text = "No evidence text."
    elif r < 0.13:
        text = ""
    ev = {"text": text}
    p = rng.random()
    ev["pmid"] = str(1000 + k) if p < 0.7 else (2000 + k if p < 0.8 else None)
    c = rng.random()
    if c < 0.15:
        ev["context"] = {"species": {"name": ("human", "mouse", "rat")[k % 3]}}
    elif c < 0.35:
        ev["context"] = {"cell_line": {"name": CELL_LINES[rng.integers(0, 20)]}}
    elif c < 0.42:
        ev["context"] = {"disease": {"db_refs": {"TEXT": f"disease {k % 4}"}}}
    elif c < 0.50:
        ev["annotations"] = {"location": ("nucleus", "cytoplasm")[k % 2]}
    elif c < 0.53:
        ev["context"] = {"species": "human", "location": {"name": "membrane"}}
    return ev


def _statement(rng, a, b, k):
    """One statement over agents ``a`` and ``b`` (dicts), of a type drawn
    from everything ``statement_edges`` handles, and some it skips."""
    kinds = ("Activation", "IncreaseAmount", "Inhibition", "DecreaseAmount", "Association",
             "RegulateAmount", "RegulateActivity", "Influence", "Phosphorylation",
             "Dephosphorylation", "Ubiquitination", "Deacetylation", "Complex", "Gef", "Gap",
             "Conversion", "ActiveForm")
    t = kinds[k % len(kinds)]
    n_ev = int(rng.integers(0, 3)) + 1
    stmt = {"type": t, "evidence": [_evidence(rng, k * 7 + j) for j in range(n_ev)]}
    belief = rng.random()
    if belief < 0.8:
        stmt["belief"] = round(float(rng.random()), 4)
    elif belief < 0.9:
        stmt["belief"] = 1
    if t in ("Phosphorylation", "Dephosphorylation", "Ubiquitination", "Deacetylation"):
        stmt.update(enz=a, sub=b)
    elif t == "Complex":
        stmt["members"] = [a, b]
    elif t == "Gef":
        stmt.update(gef=a, ras=b)
    elif t == "Gap":
        stmt.update(gap=a, ras=b)
    elif t == "Conversion":
        stmt.update(subj=a, obj_to=[b], obj_from=[a] if k % 2 else [])
    elif t == "ActiveForm":
        stmt["agent"] = a
    else:
        stmt.update(subj=a, obj=b)
    return stmt


def seeded_corpus(seed, second_first=False):
    """Two islands with the same statements over disjoint agents (so two
    largest components of equal size), multi-edges, TEXT agents (alone
    and inside complexes) and a small separate component."""
    rng = np.random.default_rng(seed)
    plan = []
    for k in range(160):
        a, b = (int(i) for i in rng.integers(0, 40, 2))
        plan.append((a, b, k, rng.random() < 0.1))
    out = []
    state = rng.bit_generator.state
    for offset in ((100, 0) if second_first else (0, 100)):
        rng.bit_generator.state = state          # the same draws for both islands
        for a, b, k, text in plan:
            out.append(_statement(rng, _agent(a + offset), _agent(b + offset, text=text), k))
    for k in range(8):                          # a small separate component
        out.append(_statement(rng, _agent(300 + k % 3), _agent(303 + k % 2), k))
    out.append({"type": "Complex", "members": [_agent(5)], "evidence": [{"text": "one"}]})
    out.append({"type": "Activation", "subj": _agent(6), "evidence": []})
    return out


def write_jsonl(path, statements):
    with open(path, "w") as f:
        for s in statements:
            f.write(json.dumps(s) + "\n")
        f.write("{not json\n")


CORPORA = {
    "test_indra_extraction": (_statements, {}),
    "seeded": (lambda: seeded_corpus(0), {}),
    "seeded, second island first": (lambda: seeded_corpus(1, second_first=True), {}),
    "seeded, capped, chunked": (lambda: seeded_corpus(2), dict(triples_per_class=3,
                                                                batch_size=7)),
    "no task rows": (lambda: [{"type": "Association", "subj": _agent(i), "obj": _agent(i + 1),
                               "evidence": [{"text": f"e{i}"}]} for i in range(12)], {}),
}


@pytest.mark.parametrize("name", list(CORPORA))
def test_read_indra_triples_byte_equal(name, tmp_path):
    make, kw = CORPORA[name]
    raw = tmp_path / "statements.jsonl"
    write_jsonl(raw, make())
    got = text.read_indra_triples(str(raw), str(tmp_path / "port"), **kw)
    want = jext.read_indra_triples(str(raw), str(tmp_path / "jax"), **kw)
    assert {k: os.path.relpath(v, tmp_path / "port") for k, v in got.items()} == \
        {k: os.path.relpath(v, tmp_path / "jax") for k, v in want.items()}
    files = tree_bytes(tmp_path / "port")
    assert files == tree_bytes(tmp_path / "jax")
    assert "pretraining/pretraining_triples.tsv" in files and "misc/summary.tsv" in files
    if name.startswith("seeded"):
        written = {os.path.dirname(p) for p in files}
        assert {"species", "cell_line", "disease", "location", "relation_type"} <= written
        # only the first-discovered of the two largest components is left
        pre = pd.read_csv(got["pretraining"], sep="\t")
        nodes = set(pre["source"]) | set(pre["target"])
        first = 100 if "second" in name else 0
        assert any(f"G{first + i}" in n for n in nodes for i in range(40))
        assert not any(f"G{100 - first + i} " in n or f"G{100 - first + i})" in n
                       for n in nodes for i in range(40))
    if name == "no task rows":
        assert files["relation_type/relation_type.tsv"] == b"\n"


def test_graph_half_steps_match_jax():
    """The steps one by one on the seeded corpus: the counts and the
    graphs' node and edge orders."""
    stmts = seeded_corpus(3)
    g, jg = text.from_indra_statements(stmts), jext.from_indra_statements(stmts)

    def same():
        assert g.nodes(data=True) == list(jg.nodes(data=True))
        assert list(g.edges(keys=True, data=True)) == list(jg.edges(keys=True, data=True))

    same()
    assert text.remove_ungrounded_nodes(g) == jext.remove_ungrounded_nodes(jg) > 0
    same()
    assert text.keep_largest_component(g) == jext.keep_largest_component(jg) > 0
    same()
    for ctx in ("species", "cell_line"):
        e, sub = text.create_context_type_specific_subgraph(g, [ctx])
        je, jsub = jext.create_context_type_specific_subgraph(jg, [ctx])
        assert e == je and list(sub.edges(keys=True, data=True)) == list(
            jsub.edges(keys=True, data=True))
    assert text.munge_evidence_text("a [XREF_BIBR, XREF_BIBR] b") == "a  b"


# ---------------------------------------------------------------------------
# protein sequences and the TransE TSV
# ---------------------------------------------------------------------------

def _task_frame(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "source": [f"p(HGNC:{i})" for i in range(n)],
        "target": [f'a(CHEBI:"c {i}")' for i in range(n)],
        "source_id": rng.integers(1, 12, n), "target_id": rng.integers(1, 12, n),
        "evidence": [f"ev {i}\twith tab" if i % 5 == 0 else f"ev {i}" for i in range(n)],
        "class": rng.choice(["up", "down"], n)})


def test_add_protein_sequences_byte_equal_with_resume(tmp_path):
    df = _task_frame()
    inp = tmp_path / "task.tsv"
    df.to_csv(inp, sep="\t", index=False)
    seqs = {str(i): "MKT" + "A" * i for i in range(1, 12) if i % 4}
    kw = dict(lookup=tprot_seq.dict_lookup(seqs), chunk_size=5)
    jkw = dict(lookup=jprot_seq.dict_lookup(seqs), chunk_size=5)
    n = tprot_seq.add_protein_sequences_per_task(str(inp), str(tmp_path / "t.tsv"), **kw)
    assert n == jprot_seq.add_protein_sequences_per_task(str(inp), str(tmp_path / "j.tsv"), **jkw)
    full = (tmp_path / "t.tsv").read_bytes()
    assert full == (tmp_path / "j.tsv").read_bytes() and 0 < n < len(df)
    # a partial output: the first chunk's rows only, then both resume
    df.iloc[:5].to_csv(tmp_path / "head.tsv", sep="\t", index=False)
    tprot_seq.add_protein_sequences_per_task(str(tmp_path / "head.tsv"),
                                             str(tmp_path / "part.tsv"), **kw)
    for tag, fn, args in (("t", tprot_seq.add_protein_sequences_per_task, kw),
                          ("j", jprot_seq.add_protein_sequences_per_task, jkw)):
        out = tmp_path / f"resumed_{tag}.tsv"
        shutil.copy(tmp_path / "part.tsv", out)
        assert fn(str(inp), str(out), **args) == n
        assert out.read_bytes() == full
    # an empty stale output starts over
    (tmp_path / "empty.tsv").write_text("")
    tprot_seq.add_protein_sequences_per_task(str(inp), str(tmp_path / "empty.tsv"), **kw)
    assert (tmp_path / "empty.tsv").read_bytes() == full


def _transe_inputs(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(bert_vocab(128)) + "\n")
    names = [f"p(HGNC:{i})" for i in range(10)] + ["increases", "decreases"]
    vecs = np.random.default_rng(0).normal(size=(len(names), 4)).astype(np.float32)
    idx = {n: i for i, n in enumerate(names)}
    rng = np.random.default_rng(1)
    n = 17
    df = pd.DataFrame({
        "source": [names[i] if i != 3 else "p(HGNC:missing)" for i in rng.integers(0, 10, n)],
        "relation": rng.choice(["increases", "decreases"], n),
        "target": [names[i] for i in rng.integers(0, 10, n)],
        "evidence": [" ".join(rng.choice(WORDS, rng.integers(2, 9))) for _ in range(n)]})
    df.loc[4, "source"] = "p(HGNC:missing)"
    return (df, (ttranse.TransEArtifacts(names, idx, vecs), BertTokenizer(str(vocab))),
            (jtranse.TransEArtifacts(names, idx, vecs), JaxBertTokenizer(str(vocab))))


def test_transe_pretraining_tsv_byte_equal_with_resume(tmp_path):
    df, port, jax_ = _transe_inputs(tmp_path)
    kw = dict(chunk_size=6, seed=3, text_part_length=12)
    skips = ttranse.transe_pretraining_to_tsv(df, *port, str(tmp_path / "t.tsv"), **kw)
    assert skips == jtranse.transe_pretraining_to_tsv(df, *jax_, str(tmp_path / "j.tsv"), **kw)
    full = (tmp_path / "t.tsv").read_bytes()
    assert skips > 0 and full == (tmp_path / "j.tsv").read_bytes()
    assert (tmp_path / "t.tsv.progress").read_text() == str(len(df))
    # a dict of columns works as the DataFrame does
    ttranse.transe_pretraining_to_tsv({k: list(df[k]) for k in df}, *port,
                                      str(tmp_path / "d.tsv"), **kw)
    assert (tmp_path / "d.tsv").read_bytes() == full
    # resumed after the first chunk, from the sidecar and without it
    for sidecar in (True, False):
        for tag, fn, art in (("t", ttranse.transe_pretraining_to_tsv, port),
                             ("j", jtranse.transe_pretraining_to_tsv, jax_)):
            out = tmp_path / f"r{tag}{sidecar}.tsv"
            fn(df.iloc[:6], *art, str(out), **kw)
            if not sidecar:
                os.remove(str(out) + ".progress")
            fn(df, *art, str(out), **kw)
        got = (tmp_path / f"rt{sidecar}.tsv").read_bytes()
        assert got == (tmp_path / f"rj{sidecar}.tsv").read_bytes()
        if sidecar:
            assert got == full


# ---------------------------------------------------------------------------
# the batteries
# ---------------------------------------------------------------------------

def task_dir(tmp_path, names):
    """Every battery file but the multiclass one, rows over ``names``."""
    rng = np.random.default_rng(5)
    root = tmp_path / "tasks"
    for directory, file_name, column, _ in tbat.BASELINE_TASKS:
        if "multiclass" in file_name:
            continue
        os.makedirs(root / directory, exist_ok=True)
        n = 24
        df = pd.DataFrame({
            "source": [names[i] for i in rng.integers(0, len(names), n)],
            "relation": "increases",
            "target": [names[i] for i in rng.integers(0, len(names), n)],
            "evidence": [" ".join(rng.choice(WORDS, 4)) + f" {i}" for i in range(n)]})
        df.loc[0, "source"] = "p(HGNC:not in the KG)"
        if directory == "relation_type":
            df["interaction"] = rng.choice(["direct_interaction", "indirect_interaction"], n)
            df["polarity"] = rng.choice(["up", "down"], n)
        else:
            df["class"] = rng.choice(["a", "b"], n)
        df.to_csv(root / directory / file_name, sep="\t", index=False)
    return str(root)


def recorder(store):
    def fake(*args, **kw):
        store.append((kw.get("task_name"), args, kw))
        return {"f1_score_mean": 0.0, "f1_score_std": 0.0}
    return fake


def test_kg_battery(tmp_path, monkeypatch):
    art = jart.make_random_artifacts(30, dim=6, rw_len=3, seed=0, name_fmt="p(HGNC:{})")
    port_art = tart.KGArtifacts(list(art.names), dict(art.name_to_idx), art.vectors,
                                art.walk_indices, art.rw_len)
    root = task_dir(tmp_path, art.names)
    got = tbat.run_all_kg_baseline_tasks(root, port_art, epochs=2, cv=2, device="cpu")
    tasks = [t for _, _, _, t in tbat.BASELINE_TASKS if t != "correct_multiclass"]
    assert list(got) == tasks
    for directory, file_name, column, task in tbat.BASELINE_TASKS:
        if task not in got:
            continue
        df = pd.read_csv(os.path.join(root, directory, file_name), sep="\t")
        feats = tkg.build_node2vec_features(port_art, df["source"].tolist(),
                                            df["target"].tolist())
        assert got[task] == tkg.run_kg_baseline_cv(feats, df[column].to_numpy(object),
                                                   task_name=task, epochs=2, cv=2,
                                                   device="cpu")
    # the JAX battery hands its CV the same features and labels
    seen = {"t": [], "j": []}
    monkeypatch.setattr(tbat, "run_kg_baseline_cv", recorder(seen["t"]))
    monkeypatch.setattr(jkg, "run_kg_baseline_cv", recorder(seen["j"]))
    tbat.run_all_kg_baseline_tasks(root, port_art, cv=2)
    jbat.run_all_kg_baseline_tasks(root, art, cv=2)
    assert [s[0] for s in seen["t"]] == [s[0] for s in seen["j"]] == tasks
    for (_, (f, y), kw), (_, (jf, jy), jkw) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(f, jf)
        assert list(y) == list(jy) and kw == jkw


def test_transe_kg_battery_hands_the_jax_features(tmp_path, monkeypatch):
    names = [f"p(HGNC:{i})" for i in range(12)] + ["increases"]
    vecs = np.random.default_rng(0).normal(size=(13, 4)).astype(np.float32)
    idx = {n: i for i, n in enumerate(names)}
    root = task_dir(tmp_path, names[:12])
    seen = {"t": [], "j": []}
    monkeypatch.setattr(tbat, "run_kg_baseline_cv", recorder(seen["t"]))
    monkeypatch.setattr(jkg, "run_kg_baseline_cv", recorder(seen["j"]))
    tbat.run_all_kg_baseline_tasks(root, ttranse.TransEArtifacts(names, idx, vecs),
                                   variant="transe")
    jbat.run_all_kg_baseline_tasks(root, jtranse.TransEArtifacts(names, idx, vecs),
                                   variant="transe")
    assert len(seen["t"]) == len(seen["j"]) == 7
    for (_, (f, y), _), (_, (jf, jy), _) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(f, jf)
        assert list(y) == list(jy)


NLP_TINY = dict(vocab_size=128, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, max_position_embeddings=16, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def test_nlp_battery(tmp_path, monkeypatch):
    names = [f"p(HGNC:{i})" for i in range(20)]
    root = task_dir(tmp_path, names)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(bert_vocab(128)) + "\n")
    tok, jtok = BertTokenizer(str(vocab)), JaxBertTokenizer(str(vocab))
    cfg = BertConfig(**NLP_TINY)
    kw = dict(epochs=1, cv=2, batch_size=8, device="cpu")
    got = tbat.run_all_nlp_baseline_tasks(root, cfg, tok, kg_entity_names=set(names),
                                          max_length=16, **kw)
    assert len(got) == 7 and "correct_multiclass" not in got
    df = pd.read_csv(os.path.join(root, "species", "species_no_duplicates.tsv"), sep="\t")
    df = df[df["source"].isin(set(names)) & df["target"].isin(set(names))].reset_index(drop=True)
    feats = tnlp.preprocess_evidences(df["evidence"].tolist(), tok, max_length=16)
    assert got["species"] == tnlp.run_nlp_baseline_cv(
        cfg, feats, df["class"].to_numpy(object), task_name="species", **kw)
    # the JAX battery hands its CV the same features and labels
    seen = {"t": [], "j": []}
    monkeypatch.setattr(tbat, "run_nlp_baseline_cv", recorder(seen["t"]))
    monkeypatch.setattr(jnlp, "run_nlp_baseline_cv", recorder(seen["j"]))
    tbat.run_all_nlp_baseline_tasks(root, cfg, tok, kg_entity_names=set(names), max_length=16)
    jbat.run_all_nlp_baseline_tasks(root, jconfig.BertConfig(**NLP_TINY), jtok,
                                    kg_entity_names=set(names), max_length=16)
    assert [s[0] for s in seen["t"]] == [s[0] for s in seen["j"]]
    for (_, (_, f, y), _), (_, (_, jf, jy), _) in zip(seen["t"], seen["j"]):
        assert f.keys() == jf.keys() and len(y) < 24
        for k in f:
            np.testing.assert_array_equal(f[k], jf[k])
        assert list(y) == list(jy)
