"""The port's baselines and losses against the JAX package, on the CPU.

* losses: ``weighted_cross_entropy`` (also against
  ``torch.nn.CrossEntropyLoss(weight=...)``), ``mse_loss``,
  ``bce_with_logits`` and ``masked_cross_entropy``'s ``label_weights``,
  within 1e-6 relative;
* KG baseline: node2vec and TransE features equal, the INS weights equal,
  and the model learning the separable task of ``tests/test_baselines.py``
  (its weights and dropout are drawn by torch, so the JAX run is not
  matched step for step);
* NLP baseline: the tokenized evidences equal, the logits (within 1e-5)
  and the gradients of every leaf (within 1e-4 of max |grad|) at fp32 in
  training mode with the dropouts at 0, and the separable task learnt.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.baselines import kg_baseline as jkg
from stonkgs_tpu.baselines import nlp_baseline as jnlp
from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.data.transe import TransEArtifacts as JaxTransEArtifacts
from stonkgs_tpu.data.wordpiece import BertTokenizer as JaxBertTokenizer
from stonkgs_tpu.ops import losses as jlosses
from stonkgs_tpu_torch.baselines import kg_baseline as tkg
from stonkgs_tpu_torch.baselines import nlp_baseline as tnlp
from stonkgs_tpu_torch.data import artifacts as tart
from stonkgs_tpu_torch.data.transe import TransEArtifacts
from stonkgs_tpu_torch.data.wordpiece import BertTokenizer
from stonkgs_tpu_torch.ops import losses as tlosses
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import bert_params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_map

from test_torch_finetuning import _named
from test_torch_models import port_cfg

VOCAB = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "up", "down", "alpha", "beta", "signal"]
NLP_CFG = jconfig.BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=64,
                             max_position_embeddings=8, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: its many small eager steps gain
    nothing from intra-op threads, which contend with the other test
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["weighted_cross_entropy", "label_weights", "mse_loss",
                                  "bce_with_logits"])
def test_losses_match_jax(case):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6)
    if case == "weighted_cross_entropy":
        w = rng.uniform(0.1, 2.0, 5).astype(np.float32)
        got = tlosses.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                             torch.from_numpy(w))
        want = jlosses.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                              jnp.asarray(w))
        ref = torch.nn.CrossEntropyLoss(weight=torch.from_numpy(w))(
            torch.from_numpy(logits), torch.from_numpy(labels))
        np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    elif case == "label_weights":
        labels[[1, 4]] = -100
        lw = rng.uniform(0.0, 2.0, 6).astype(np.float32)
        got = tlosses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           label_weights=torch.from_numpy(lw))
        want = jlosses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            label_weights=jnp.asarray(lw))
    elif case == "mse_loss":
        other = rng.normal(size=logits.shape).astype(np.float32)
        got = tlosses.mse_loss(torch.from_numpy(logits), torch.from_numpy(other))
        want = jlosses.mse_loss(jnp.asarray(logits), jnp.asarray(other))
    else:
        t = rng.integers(0, 2, logits.shape).astype(np.float32)
        got = tlosses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(t))
        want = jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(t))
        ref = torch.nn.BCEWithLogitsLoss()(torch.from_numpy(logits), torch.from_numpy(t))
        np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_node2vec_features_match_jax():
    art = jart.make_random_artifacts(n_entities=10, dim=4, rw_len=3, seed=0)
    port_art = tart.KGArtifacts(list(art.names), dict(art.name_to_idx), art.vectors,
                                art.walk_indices, art.rw_len)
    src, tgt = ["node1", "missing", "node9"], ["node2", "node3", "gone"]
    got = tkg.build_node2vec_features(port_art, src, tgt)
    want = jkg.build_node2vec_features(art, src, tgt)
    assert got.dtype == want.dtype and got.shape == (3, 6, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, :3], 0.0)     # unknown source: zeros


def test_transe_features_match_jax():
    names = ["a", "b", "rel"]
    vecs = np.arange(9).reshape(3, 3).astype(np.float32)
    got = tkg.build_transe_features(TransEArtifacts(names, {n: i for i, n in enumerate(names)},
                                                    vecs), ["a", "x"], ["rel", "rel"],
                                    ["b", "a"])
    want = jkg.build_transe_features(JaxTransEArtifacts(
        names, {n: i for i, n in enumerate(names)}, vecs), ["a", "x"], ["rel", "rel"],
        ["b", "a"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], vecs[[0, 2, 1]])


def test_ins_class_weights_match_jax():
    labels = np.array([0, 0, 0, 1, 3, 3])
    got = tkg.ins_class_weights(labels, 4)
    np.testing.assert_array_equal(got, jkg.ins_class_weights(labels, 4))
    np.testing.assert_allclose(got, [1 / 3, 1.0, 1.0, 0.5])


def test_kg_baseline_learns_separable(tmp_path):
    """Class set by the sign of one embedding dimension
    (``tests/test_baselines.py:47-59``); the predictions' TSV."""
    rng = np.random.default_rng(0)
    n = 120
    y = rng.integers(0, 2, n)
    feats = rng.normal(size=(n, 8, 16)).astype(np.float32)
    feats[:, :, 0] = np.where(y[:, None] == 1, 3.0, -3.0)
    labels = np.array(["pos" if v else "neg" for v in y], object)
    result = tkg.run_kg_baseline_cv(feats, labels, epochs=30, lr=1e-2, cv=2, seed=1,
                                    task_name="toy", output_dir=str(tmp_path), device="cpu")
    assert result["f1_score_mean"] > 0.9, result
    lines = (tmp_path / "predicted_labels_kg_toydf.tsv").read_text().splitlines()
    assert lines[0] == "split\tindex\tpredicted_label\ttrue_label" and len(lines) == 1 + n


def _tokenizers(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    return BertTokenizer(str(vocab)), JaxBertTokenizer(str(vocab))


def test_nlp_baseline_logits_and_grads_match_jax(tmp_path):
    tok, jtok = _tokenizers(tmp_path)
    texts = ["up alpha signal", "down", "beta beta up down signal alpha", "alpha"]
    feats = tnlp.preprocess_evidences(texts, tok, max_length=8)
    want_feats = jnlp.preprocess_evidences(texts, jtok, max_length=8)
    assert feats.keys() == want_feats.keys()
    for k in feats:
        np.testing.assert_array_equal(feats[k], want_feats[k])
        assert feats[k].dtype == want_feats[k].dtype
    batch = {**feats, "labels": np.array([0, 1, 2, 1])}
    jp = jnlp.init_nlp_baseline_params(jax.random.PRNGKey(0), NLP_CFG, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(deterministic=False, dropout_rng=jax.random.PRNGKey(1))
    jlogits, ((jloss, _), jgrads) = jax.jit(lambda p: (
        jnlp.classification_logits(p, NLP_CFG, jb, **kw),
        jax.value_and_grad(lambda q: jnlp.classification_loss(q, NLP_CFG, jb, **kw),
                           has_aux=True)(p)))(jp)

    tcfg = port_cfg(NLP_CFG)

    def port(tree):
        tree = jax.tree.map(np.asarray, tree)
        return {"bert": bert_params_from_jax(tree["bert"], tcfg),
                "classifier": tree_map(lambda a: torch.from_numpy(np.array(a)),
                                       tree["classifier"])}

    tp = port(jp)
    tb = tpre.to_device(batch, "cpu")
    tkw = dict(deterministic=False, rng=tpre.step_rng(0, 0, "cpu"))
    np.testing.assert_allclose(tnlp.classification_logits(tp, tcfg, tb, **tkw).numpy(),
                               np.asarray(jlogits), atol=1e-5, rtol=0)
    named = _named(tp)
    for t in named.values():
        t.requires_grad_(True)
    tloss, _ = tnlp.classification_loss(tp, tcfg, tb, **tkw)
    grads = torch.autograd.grad(tloss, list(named.values()), allow_unused=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = _named(port(jgrads))
    assert want.keys() == named.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for (name, w), g in zip(want.items(), grads):
        got = torch.zeros_like(w) if g is None else g
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_nlp_baseline_learns_separable(tmp_path):
    """``tests/test_baselines.py:62-77`` through the port, on the CPU."""
    tok, _ = _tokenizers(tmp_path)
    rng = np.random.default_rng(0)
    n = 48
    y = rng.integers(0, 2, n)
    feats = tnlp.preprocess_evidences(
        ["up alpha signal" if v else "down beta signal" for v in y], tok, max_length=8)
    labels = np.array(["pos" if v else "neg" for v in y], object)
    result = tnlp.run_nlp_baseline_cv(port_cfg(NLP_CFG), feats, labels, epochs=40, lr=3e-3,
                                      batch_size=8, cv=2, seed=0, device="cpu",
                                      task_name="toy", output_dir=str(tmp_path))
    assert result["f1_score_mean"] > 0.9, result
    assert (tmp_path / "predicted_labels_nlp_toydf.tsv").exists()

