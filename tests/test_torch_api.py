"""The port's serving API against the JAX package, on the CPU at fp32.

Both engines are loaded by ``from_pretrained`` from the files of
``tests/test_torch_hf_io.py`` (a JAX-written checkpoint with a
classifier, node2vec TSVs with BEL names, a vocabulary, all in
``tmp_path``).  Then, against the JAX functions on the same inputs:

* ``embed_stream`` (raw rows -> embeddings, chunk by chunk), and equal to
  the port's ``embed`` on the same features;
* ``infer`` / ``infer_iter`` / ``infer_concat`` / ``infer_concat_iter`` on
  DataFrames, row tuples and INDRA statement JSON (the statements of
  ``tests/test_indra_extraction.py`` and a few more types; their nodes are
  not in the KG and take the UNK walk), and ``statement_edges`` itself;
* ``preprocess_df_for_embeddings`` (equal features) and
  ``get_stonkgs_embeddings`` with a port engine.

Embeddings, logits and probabilities are held to atol 1e-5, rtol 1e-4;
the KG table each package builds from the same backbone differs in the
last digits (``tests/test_torch_hf_io.py``), so each engine here gets the
JAX engine's table and the two forwards differ only in their sums' order.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from stonkgs_tpu.api import api as japi
from stonkgs_tpu.api import embeddings as jemb
from stonkgs_tpu.api.inference import STonKGsEngine as JaxEngine
from stonkgs_tpu.data import indra_extraction as jindra
from stonkgs_tpu_torch import STonKGsEngine
from stonkgs_tpu_torch.api import api as tapi
from stonkgs_tpu_torch.api import embeddings as temb
from stonkgs_tpu_torch.data import indra_extraction as tindra

from test_indra_extraction import _agent, _ev, _statements
from test_torch_hf_io import _rows, files  # noqa: F401 -- the fixture

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def engines(files):  # noqa: F811 -- the fixture
    kw = dict(vocab_file=files["vocab"], compute_dtype="float32", batch_size=4)
    args = (files["ckpt"], files["emb"], files["walks"])
    jeng = JaxEngine.from_pretrained(*args, **kw)
    eng = STonKGsEngine.from_pretrained(*args, device="cpu", **kw)
    eng.params["kg_backbone"] = torch.from_numpy(np.array(jeng.params["kg_backbone"]))
    return eng, jeng


def test_embed_stream_matches_jax_and_embed(files, engines):  # noqa: F811
    eng, jeng = engines
    src, tgt, ev = _rows(files["names"], 11, seed=7)
    src[3] = "p(HGNC:0 ! NOT_IN_KG)"
    rows = list(zip(src, tgt, ev))
    for masking in (False, True):
        got = list(eng.embed_stream(iter(rows), chunk_rows=4, apply_masking=masking, seed=2))
        want = list(jeng.embed_stream(iter(rows), chunk_rows=4, apply_masking=masking, seed=2))
        assert [g.shape for g in got] == [(4, 64), (4, 64), (3, 64)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    got = np.concatenate(list(eng.embed_stream(rows, chunk_rows=4, apply_masking=False)))
    feats = eng.preprocess(src, tgt, ev, apply_masking=False)
    np.testing.assert_array_equal(got, eng.embed(feats))
    # bucketed, a chunk is a request of its own: embed chunk by chunk
    bucketed = dataclasses.replace(eng, length_buckets=(8,))
    got_b = list(bucketed.embed_stream(rows, chunk_rows=4, apply_masking=False))
    for i, g in enumerate(got_b):
        chunk = {k: v[4 * i: 4 * i + 4] for k, v in feats.items()}
        np.testing.assert_array_equal(g, bucketed.embed(chunk))
    assert list(eng.embed_stream(iter([]))) == []


def _more_statements():
    """The extraction tests' statements, one without evidence text, and a
    Gef, a Conversion and a Translocation (no binary edge)."""
    return _statements() + [
        {"type": "Activation", "subj": _agent("NOEV", ident="5"),
         "obj": _agent("NOEV2", ident="6"), "belief": 0.1, "evidence": [_ev("")]},
        {"type": "Gef", "gef": _agent("SOS1", ident="7"), "ras": _agent("KRAS", ident="8"),
         "evidence": [_ev("SOS1 activates KRAS.")]},
        {"type": "Conversion", "subj": _agent("ENZ", ident="9"),
         "obj_to": [_agent("P1", ident="10")], "obj_from": [_agent("R1", ident="11")],
         "evidence": [_ev("ENZ converts R1 to P1.")]},
        {"type": "Translocation", "agent": _agent("AKT1", ident="391")},
    ]


def test_statement_edges_match_jax():
    for stmt in _more_statements():
        assert tindra.statement_edges(stmt) == jindra.statement_edges(stmt)
    for name in ("INCREASES", "DIRECT_RELATIONS", "UP_RELATIONS", "DOWN_RELATIONS",
                 "CONTEXT_KEYS", "_STMT_RELATION", "_MODIFICATIONS"):
        assert getattr(tindra, name) == getattr(jindra, name), name
    agent = {"name": "x", "db_refs": {"CHEBI": "1", "GO": "2"}}
    assert tindra.ground_agent(agent) == jindra.ground_agent(agent)
    assert tindra.agent_node({"name": "", "db_refs": {}}) == \
        jindra.agent_node({"name": "", "db_refs": {}})


def _inputs(files):  # noqa: F811
    src, tgt, ev = _rows(files["names"], 6, seed=9)
    tuples = [(s, t, e) for s, t, e in zip(src, tgt, ev)]
    df = pd.DataFrame(tuples, columns=["source", "target", "evidence"])
    return {"dataframe": df, "tuples": tuples, "statements": _more_statements()}


@pytest.mark.parametrize("kind", ["dataframe", "tuples", "statements"])
def test_infer_matches_jax(files, engines, kind):  # noqa: F811
    eng, jeng = engines
    data = _inputs(files)[kind]
    assert len(tapi._prepare_df(data)) > 0
    pd.testing.assert_frame_equal(tapi._prepare_df(data), japi._prepare_df(data))
    (lg, pr), (jlg, jpr) = tapi.infer(eng, data), japi.infer(jeng, data)
    assert len(lg) == len(jlg)
    np.testing.assert_allclose(np.stack(lg), np.stack(jlg), **TOL)
    np.testing.assert_allclose(np.array(pr), np.array(jpr), **TOL)
    got = list(tapi.infer_concat(eng, data, columns=["a", "b", "c"]))
    want = list(japi.infer_concat(jeng, data, columns=["a", "b", "c"]))
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[:-3] == w[:-3]
        np.testing.assert_allclose(g[-3:], w[-3:], **TOL)
    gdf = tapi.infer_concat(eng, data, as_dataframe=True)
    wdf = japi.infer_concat(jeng, data, as_dataframe=True)
    pd.testing.assert_frame_equal(gdf, wdf, check_exact=False, atol=1e-5, rtol=1e-4)
    assert list(gdf.columns[-3:]) == ["class_0", "class_1", "class_2"]


def test_prepare_df_rejects_other_inputs():
    for bad, want in (("rows", "source df"), ([1, 2], "row has")):
        for mod in (tapi, japi):
            with pytest.raises(TypeError, match=want):
                mod._prepare_df(bad)


def test_embeddings_api_matches_jax(files, engines):  # noqa: F811
    eng, jeng = engines
    src, tgt, ev = _rows(files["names"], 7, seed=11)
    df = pd.DataFrame({"source": src, "target": tgt, "evidence": ev})
    kw = dict(embedding_name_to_vector_path=files["emb"],
              embedding_name_to_random_walk_path=files["walks"],
              vocab_file_path=files["vocab"])
    for masking in (True, False):
        got = temb.preprocess_df_for_embeddings(df, apply_masking=masking, seed=4, **kw)
        want = jemb.preprocess_df_for_embeddings(df, apply_masking=masking, seed=4, **kw)
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            np.testing.assert_array_equal(np.stack(got[c]), np.stack(want[c]), err_msg=c)
    for idx in (None, [5, 0, 2]):
        g = temb.get_stonkgs_embeddings(got, eng, idx)
        w = jemb.get_stonkgs_embeddings(want, jeng, idx)
        assert list(g.columns) == ["embedding"] and len(g) == len(w)
        np.testing.assert_allclose(np.array(g["embedding"].tolist()),
                                   np.array(w["embedding"].tolist()), **TOL)
    for name in (None, "stonkgs/stonkgs-150k"):
        with pytest.raises(ValueError, match="not ported"):
            temb.get_stonkgs_embeddings(got, name)
