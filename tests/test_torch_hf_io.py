"""The port's checkpoint I/O and its README flow against the JAX package.

Every file is written in ``tmp_path``: an HF-format checkpoint (by either
package's ``save_pretrained``), node2vec TSVs with BEL-style names, TransE
embeddings and vocabularies.  Then:

* loading: the port's ``hf_loader`` against ``params_from_jax`` of the
  JAX loader's tree (``.bin`` and ``.safetensors``), equal leaf for leaf;
* writing: the port's ``save_pretrained`` against the JAX state dict,
  equal key for key, and read back by both packages exactly;
* the README flow: ``from_pretrained`` -> ``preprocess`` -> ``embed`` /
  ``logits`` on the CPU at fp32 against the JAX engine on the same files
  (features equal; embeddings and logits within atol 1e-4, rtol 1e-4, as
  ``tests/test_torch_engine.py``), for STonKGs, TransESTonKGs and
  ProtSTonKGs.  A KG table is computed by each framework from the same
  backbone, so it is held to the same tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.api.inference import STonKGsEngine as JaxEngine
from stonkgs_tpu.api.prot_inference import ProtSTonKGsEngine as JaxProtEngine
from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.utils import hf_export as jexport
from stonkgs_tpu.utils import hf_loader as jloader
from stonkgs_tpu_torch import ProtSTonKGsEngine, STonKGsEngine
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.utils import hf_export as texport
from stonkgs_tpu_torch.utils import hf_loader as tloader
from stonkgs_tpu_torch.utils.convert import params_from_jax, protstonkgs_params_from_jax

from test_torch_data import bel_names
from test_torch_models import port_cfg
from test_torch_protstonkgs import port_cfg as prot_port_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
RW_LEN = 7                       # half = 2 * 7 + 2 = 16
N_ENTITIES = 101                 # the fewest whose table holds rows 100/102/103
BERT = jconfig.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=32)
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=N_ENTITIES, text_len=16,
                            entity_len=16, num_labels=3)
WORDS = ["alpha", "beta", "gamma", "activates", "inhibits", "cdh", "##1", "protein",
         "binds", "p53", "##s", "in", "cells", "the", "increases", "decreases"]
AMINO = list("LAGVESIKRDTPNQFYMHCWXUBZO")
PROT_CFG = jconfig.ProtSTonKGsConfig(   # the published layout, 2 layers a stack
    trunk=jconfig.BigBirdConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=64),
    lm=jconfig.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=1, intermediate_size=64,
                          max_position_embeddings=256),
    prot=jconfig.BertConfig(vocab_size=30, hidden_size=16, num_hidden_layers=2,
                            num_attention_heads=1, intermediate_size=32,
                            max_position_embeddings=3072),
    kg_vocab_size=120, sep_id=66, mask_id=67, unk_id=100)


def bert_vocab(size):
    """A BERT vocabulary of ``size`` lines with the specials at BioBERT's
    ids (PAD 0, UNK 100, CLS 101, SEP 102, MASK 103)."""
    tokens = [f"[unused{i}]" for i in range(size)]
    for i, t in {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
                 103: "[MASK]"}.items():
        tokens[i] = t
    tokens[1: 1 + len(WORDS)] = WORDS
    return tokens


def _trees_equal(got, want, path="", tol=None):
    """Same structure; equal leaves (within ``tol`` where given)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _trees_equal(got[k], want[k], f"{path}/{k}", tol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _trees_equal(g, w, f"{path}/{i}", tol)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if tol is None:
            assert torch.equal(got, want), path
        else:
            torch.testing.assert_close(got, want, **tol, msg=path)


def _without(tree, key):
    return {k: v for k, v in tree.items() if k != key}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-written STonKGs checkpoint, node2vec and TransE TSVs, vocab."""
    root = tmp_path_factory.mktemp("files")
    params = jax.tree.map(np.asarray, jstonkgs.init_stonkgs_params(
        jax.random.PRNGKey(0), CFG, with_classifier=True))
    jexport.save_pretrained(params, CFG, str(root / "ckpt"))
    art = jart.make_random_artifacts(N_ENTITIES, dim=64, rw_len=RW_LEN, seed=1)
    art.names = bel_names(N_ENTITIES)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    jart.save_kg_artifacts(art, root / "emb.tsv", root / "walks.tsv")
    transe_names = bel_names(N_ENTITIES - 2) + ["increases", "decreases"]
    vecs = np.random.default_rng(2).normal(size=(N_ENTITIES, 64)).astype(np.float32)
    with open(root / "transe.tsv", "w") as f:
        for n, v in zip(transe_names, vecs):
            f.write(n + "\t" + "\t".join(repr(float(x)) for x in v) + "\n")
    (root / "vocab.txt").write_text("\n".join(bert_vocab(BERT.vocab_size)) + "\n")
    return {"root": root, "params": params, "ckpt": str(root / "ckpt"),
            "emb": str(root / "emb.tsv"), "walks": str(root / "walks.tsv"),
            "transe": str(root / "transe.tsv"), "vocab": str(root / "vocab.txt"),
            "names": art.names, "transe_names": transe_names}


def _kg_table(files):
    art = jart.load_kg_artifacts(files["emb"], files["walks"])
    return np.asarray(jstonkgs.build_kg_table(files["params"]["lm_backbone"], BERT,
                                              art.vectors))


# ---------------------------------------------------------------------------
# configs and loading
# ---------------------------------------------------------------------------

def test_configs_from_hf_dicts_match_jax(files):
    path = f"{files['ckpt']}/config.json"
    assert dataclasses.asdict(tconfig.BertConfig.from_json_file(path)) == \
        dataclasses.asdict(jconfig.BertConfig.from_json_file(path))
    d = {"hidden_size": 48, "num_hidden_layers": 3, "block_size": 16,
         "attention_type": "original_full", "model_type": "big_bird", "foo": 1}
    assert dataclasses.asdict(tconfig.BigBirdConfig.from_hf_dict(d)) == \
        dataclasses.asdict(jconfig.BigBirdConfig.from_hf_dict(d))
    assert dataclasses.asdict(tconfig.BertConfig.from_hf_dict(d)) == \
        dataclasses.asdict(jconfig.BertConfig.from_hf_dict(d))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_checkpoint_matches_jax_loader(files, tmp_path, fmt):
    ckpt = files["ckpt"]
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(jloader.load_state_dict(ckpt), str(tmp_path / "model.safetensors"))
        ckpt = str(tmp_path)
    kg = _kg_table(files)
    want = params_from_jax(jloader.stonkgs_params_from_state_dict(
        jloader.load_state_dict(ckpt), CFG, kg_table=kg), port_cfg(CFG))
    sd = tloader.load_state_dict(ckpt)
    assert tloader.infer_kg_vocab_size(sd) == N_ENTITIES
    got = tloader.stonkgs_params_from_state_dict(sd, port_cfg(CFG),
                                                 kg_table=torch.from_numpy(kg))
    _trees_equal(got, want)
    assert all(t.is_contiguous() for t in
               (got["trunk"]["encoder"][0]["intermediate"]["kernel"],
                got["cls"]["predictions"]["entity_decoder"]["kernel"]))


@pytest.fixture(scope="module")
def prot_files(files, tmp_path_factory):
    """A JAX-written ProtSTonKGs checkpoint (2 layers a stack, published
    layout), its node2vec TSVs and both vocabularies."""
    root = tmp_path_factory.mktemp("prot")
    params = jax.tree.map(np.asarray, jprot.init_protstonkgs_params(
        jax.random.PRNGKey(3), PROT_CFG))
    jexport.save_protstonkgs_pretrained(params, PROT_CFG, str(root / "ckpt"))
    art = jart.make_random_artifacts(120, dim=32, rw_len=127, seed=4)
    art.names = bel_names(120)
    art.name_to_idx = {n: i for i, n in enumerate(art.names)}
    jart.save_kg_artifacts(art, root / "emb.tsv", root / "walks.tsv")
    (root / "prot_vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + AMINO) + "\n")
    return {"params": params, "ckpt": str(root / "ckpt"), "emb": str(root / "emb.tsv"),
            "walks": str(root / "walks.tsv"), "names": art.names,
            "lm_vocab": files["vocab"], "prot_vocab": str(root / "prot_vocab.txt")}


def test_load_protstonkgs_checkpoint_matches_jax_loader(prot_files):
    args = (prot_files["ckpt"], prot_files["emb"], prot_files["walks"])
    jcfg, jparams = jloader.load_protstonkgs_pretrained(*args)
    cfg, params = tloader.load_protstonkgs_pretrained(*args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(PROT_CFG)
    want = protstonkgs_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       prot_port_cfg(jcfg))
    _trees_equal(_without(params, "kg_backbone"), _without(want, "kg_backbone"))
    _trees_equal(params["kg_backbone"], want["kg_backbone"], tol=TOL)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def test_save_pretrained_matches_jax_and_reads_back(files, tmp_path):
    cfg = port_cfg(CFG)
    params = params_from_jax({**files["params"], "kg_backbone": _kg_table(files)}, cfg)
    out = texport.save_pretrained(params, cfg, str(tmp_path / "port"))
    sd = torch.load(f"{out}/pytorch_model.bin", weights_only=True)
    want = jexport.stonkgs_state_dict(files["params"], CFG)
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].dtype == torch.float32 and sd[k].is_contiguous(), k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the JAX package reads it, and so does the port, exactly
    jback = jloader.stonkgs_params_from_state_dict(jloader.load_state_dict(out), CFG)
    for k in ("trunk", "lm_backbone", "cls", "classifier"):
        jax.tree.map(np.testing.assert_array_equal, jback[k], files["params"][k])
    back = tloader.stonkgs_params_from_state_dict(tloader.load_state_dict(out), cfg)
    _trees_equal(back, _without(params, "kg_backbone"))
    assert tloader.load_config(out) == jloader.load_config(files["ckpt"])


def test_protstonkgs_state_dict_matches_jax_and_round_trips(prot_files, tmp_path):
    cfg = prot_port_cfg(PROT_CFG)
    jparams = {**prot_files["params"],
               "kg_backbone": np.zeros((PROT_CFG.kg_table_size, 32), np.float32)}
    params = protstonkgs_params_from_jax(jparams, cfg)
    want = jexport.protstonkgs_state_dict(prot_files["params"], PROT_CFG)
    got = texport.protstonkgs_state_dict(params, cfg)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    out = texport.save_protstonkgs_pretrained(params, cfg, str(tmp_path / "port"))
    assert tloader.load_config(out) == jloader.load_config(prot_files["ckpt"])
    sd = tloader.load_state_dict(out)
    back_cfg = tloader.protstonkgs_config(sd, tloader.load_config(out))
    assert dataclasses.asdict(back_cfg) == dataclasses.asdict(cfg)
    _trees_equal(tloader.protstonkgs_params_from_state_dict(sd, cfg),
                 _without(params, "kg_backbone"))


# ---------------------------------------------------------------------------
# the README flow
# ---------------------------------------------------------------------------

def _rows(names, n, seed):
    rng = np.random.default_rng(seed)
    words = WORDS[:6] + ["unknownword", "CDH1", "Alpha-beta"]
    ev = [" ".join(rng.choice(words, rng.integers(0, 30))) for _ in range(n)]
    src = [names[i] for i in rng.integers(0, len(names), n)]
    tgt = [names[i] for i in rng.integers(0, len(names), n)]
    return src, tgt, ev


def _features_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", ["stonkgs", "transe"])
def test_readme_flow_matches_jax_engine(files, variant):
    kw = dict(vocab_file=files["vocab"], compute_dtype="float32", batch_size=4)
    if variant == "transe":
        args = (files["ckpt"], files["transe"])
        kw["variant"] = "transe"
        names = files["transe_names"][:-2]
        src, tgt, ev = _rows(names, 7, seed=5)
        pre = dict(relations=["increases", "decreases"] * 3 + ["increases"])
    else:
        args = (files["ckpt"], files["emb"], files["walks"])
        src, tgt, ev = _rows(files["names"], 7, seed=5)
        src[2] = "p(HGNC:0 ! NOT_IN_KG)"     # an unknown node: the UNK walk
        pre = {}
    jeng = JaxEngine.from_pretrained(*args, **kw)
    eng = STonKGsEngine.from_pretrained(*args, device="cpu", **kw)
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)
    assert eng.tokenizer.is_native
    torch.testing.assert_close(eng.params["kg_backbone"],
                               torch.from_numpy(np.asarray(jeng.params["kg_backbone"])),
                               **TOL)
    for masking in (True, False):
        feats = eng.preprocess(src, tgt, ev, apply_masking=masking, seed=3, **pre)
        _features_equal(feats, jeng.preprocess(src, tgt, ev, apply_masking=masking,
                                               seed=3, **pre))
    np.testing.assert_allclose(eng.embed(feats), jeng.embed(feats), **TOL)
    np.testing.assert_allclose(eng.logits(feats), jeng.logits(feats), **TOL)


def test_transe_preprocess_refuses_unknown_names(files):
    kw = dict(vocab_file=files["vocab"], compute_dtype="float32", variant="transe")
    eng = STonKGsEngine.from_pretrained(files["ckpt"], files["transe"], device="cpu", **kw)
    jeng = JaxEngine.from_pretrained(files["ckpt"], files["transe"], **kw)
    names = files["transe_names"]
    rows = ([names[0], "p(HGNC:0 ! NOT_IN_KG)"], [names[1], names[2]], ["alpha", "beta"])
    for e in (eng, jeng):
        with pytest.raises(ValueError, match=r"rows \[1\]"):
            e.preprocess(*rows, relations=["increases", "decreases"])
        with pytest.raises((ValueError, AssertionError)):
            e.preprocess(*rows)


def test_engine_save_pretrained_round_trips(files, tmp_path):
    eng = STonKGsEngine.from_pretrained(files["ckpt"], files["emb"], files["walks"],
                                        device="cpu", compute_dtype="float32")
    out = eng.save_pretrained(str(tmp_path / "again"))
    back = STonKGsEngine.from_pretrained(out, files["emb"], files["walks"],
                                         device="cpu", compute_dtype="float32")
    _trees_equal(back.params, eng.params)
    assert back.cfg == eng.cfg and back.tokenizer is None


def test_from_pretrained_runs_on_the_card_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        STonKGsEngine.from_pretrained(files["ckpt"], files["emb"], files["walks"])
    with pytest.raises(ValueError, match="kg_random_walk_path"):
        STonKGsEngine.from_pretrained(files["ckpt"], files["emb"], device="cpu")


def test_prot_readme_flow_matches_jax_engine(prot_files, monkeypatch):
    args = (prot_files["ckpt"], prot_files["emb"], prot_files["walks"],
            prot_files["lm_vocab"], prot_files["prot_vocab"])
    kw = dict(compute_dtype="float32", batch_size=2)
    jeng = JaxProtEngine.from_pretrained(*args, **kw)
    eng = ProtSTonKGsEngine.from_pretrained(*args, device="cpu", **kw)
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(jeng.cfg)
    assert eng.lm_tokenizer.is_native and eng.prot_tokenizer.is_native
    rng = np.random.default_rng(6)
    src, tgt, ev = _rows(prot_files["names"], 3, seed=7)
    src[0] = "p(HGNC:0 ! NOT_IN_KG)"
    rows = {"source": src, "target": tgt, "evidence": ev,
            "source_description": ["alpha binds beta", "", "protein " * 300],
            "target_description": ["gamma", "cdh1 p53", "the"],
            "source_prot": [" ".join(rng.choice(AMINO, k)) for k in (40, 2000, 0)],
            "target_prot": [" ".join(rng.choice(AMINO, k)) for k in (9, 1, 1600)]}
    feats = eng.preprocess(rows)
    _features_equal(feats, jeng.preprocess(rows))
    np.testing.assert_allclose(eng.embed(feats), jeng.embed(feats), **TOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtSTonKGsEngine.from_pretrained(*args)
