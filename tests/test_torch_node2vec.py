"""The port's KG embeddings (walker, word2vec, node2vec) against the JAX
package, on the CPU, with torch on one thread.

* the walker: ``CSRGraph`` arrays and walks (p = q = 1 and p != q, on 1
  and 4 threads) bit-equal to the JAX package's, the C++ walker built here;
  the numpy fallback equal to the JAX fallback;
* the vocabulary, keep and negative probabilities, ``_make_pairs`` and
  ``_build_alias`` bit-equal; the device slab's layout and mask equal to
  JAX's ``_device_pair_slab`` given JAX's own keep / reduced-window draws,
  the alias negatives equal given the same (cell, u);
* the updates: ``_sgd_core`` (masked and unmasked) and ``_cbow_step``
  against the JAX functions on batches where rows repeat many times,
  within 1e-6; a masked step equal to the compacted step;
* whole runs: the host pipeline with the JAX package's initial ``syn0``
  injected (skip-gram and CBOW) within ``RUN_ATOL``; the device pipeline
  learning the ring and not depending on ``slabs_per_dispatch``;
* artifacts: ``run_node2vec`` from a pre-training TSV, its walks TSV
  byte-equal to the JAX package's, its embeddings TSV with the same names
  in the same order and values within ``RUN_ATOL``, loadable by the port's
  ``load_kg_artifacts``;
* link prediction: the edge split bit-equal, the stratified split equal
  to scikit-learn's ``train_test_split`` index for index, the logistic
  regression within 1e-4 relative of scikit-learn's, the AUC equal to
  ``roc_auc_score``, ``run_link_prediction`` equal to the JAX function on
  equal vectors; the HPO grid (optuna hidden) the JAX package's trials in
  its order.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import roc_auc_score
from sklearn.model_selection import train_test_split

import jax
import jax.numpy as jnp

from stonkgs_tpu.data import walker as jwalker
from stonkgs_tpu.models import node2vec as jn2v
from stonkgs_tpu.models import word2vec as jw2v
from stonkgs_tpu_torch.data import walker as twalker
from stonkgs_tpu_torch.data.artifacts import load_kg_artifacts
from stonkgs_tpu_torch.models import node2vec as tn2v
from stonkgs_tpu_torch.models import word2vec as tw2v

# a whole small run, port against JAX from the same syn0: the pairs and
# negatives are equal, the updates differ by the order of fp32 sums
# (einsum against bmm, XLA's scatter against index_add_), which compounds
# over the run's steps; measured 1.9e-9 at most (values up to 0.03) on
# these runs
RUN_ATOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: small eager steps gain nothing from intra-op
    threads, which contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_edges(n=30):
    return [f"n{i}" for i in range(n)], [f"n{(i + 1) % n}" for i in range(n)]


def chord_edges(n=60):
    """A ring with chords: enough edges for a link-prediction split."""
    src = [f"n{i}" for i in range(n)] + [f"n{i}" for i in range(0, n, 3)]
    tgt = [f"n{(i + 1) % n}" for i in range(n)] + [f"n{(i + 7) % n}" for i in range(0, n, 3)]
    return src, tgt


def jax_syn0(monkeypatch):
    """Make the port start from the JAX package's initial syn0."""
    def init(V, dim, seed, device):
        k0 = jax.random.PRNGKey(seed)
        syn0 = (jax.random.uniform(k0, (V, dim), jnp.float32) - 0.5) / dim
        return torch.from_numpy(np.array(syn0)).to(device)
    monkeypatch.setattr(tw2v, "_init_syn0", init)


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

def test_native_walker_builds():
    assert twalker.is_native()
    assert (twalker.BUILD_DIR / "libwalker.so").exists()


def test_csr_graph_equals_jax():
    src, tgt = chord_edges(40)
    src += ["n3", "x"]        # a repeated edge and a new node
    tgt += ["n4", "n0"]
    for directed in (False, True):
        got = twalker.CSRGraph.from_edges(src, tgt, directed=directed)
        want = jwalker.CSRGraph.from_edges(src, tgt, directed=directed)
        assert got.names == want.names
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.indptr.dtype == want.indptr.dtype and got.indices.dtype == want.indices.dtype


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
@pytest.mark.parametrize("threads", [1, 4])
def test_walks_equal_jax(p, q, threads):
    g = twalker.CSRGraph.from_edges(*chord_edges())
    jg = jwalker.CSRGraph.from_edges(*chord_edges())
    got = twalker.random_walks(g, walk_len=17, epochs=3, seed=11, p=p, q=q, n_threads=threads)
    want = jwalker.random_walks(jg, walk_len=17, epochs=3, seed=11, p=p, q=q, n_threads=2)
    assert got.dtype == np.int32 and got.shape == (180, 17)
    np.testing.assert_array_equal(got, want)


def test_numpy_walks_equal_jax():
    g = twalker.CSRGraph.from_edges(*chord_edges())
    jg = jwalker.CSRGraph.from_edges(*chord_edges())
    got = twalker._numpy_walks(g, 9, 2, 5, 1.0, 1.0, np.empty((120, 9), np.int32))
    want = jwalker._numpy_walks(jg, 9, 2, 5, 1.0, 1.0, np.empty((120, 9), np.int32))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="p = q = 1"):
        twalker._numpy_walks(g, 9, 2, 5, 2.0, 1.0, np.empty((120, 9), np.int32))


# ---------------------------------------------------------------------------
# vocabulary, pairs, alias tables, the device slab
# ---------------------------------------------------------------------------

def corpus(n_tokens=40, rows=30, L=12, seed=0):
    rng = np.random.default_rng(seed)
    # a skewed unigram: a few hot tokens, as walks over hubs give
    p = 1.0 / np.arange(1, n_tokens + 1) ** 1.2
    return rng.choice(n_tokens, (rows, L), p=p / p.sum()).astype(np.int32)


def test_vocab_and_distributions_equal_jax():
    c = corpus()
    got, want = tw2v._build_vocab(c, 45), jw2v._build_vocab(c, 45)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    counts_sorted = got[0][got[1]]
    keep = tw2v._keep_probabilities(counts_sorted, 1e-2)
    # the JAX package computes both inline in train_word2vec
    total, thresh = counts_sorted.sum(), 1e-2 * counts_sorted.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        kp = (np.sqrt(counts_sorted / thresh) + 1) * (thresh / np.maximum(counts_sorted, 1))
    np.testing.assert_array_equal(keep, np.clip(kp, 0, 1).astype(np.float32))
    assert keep.min() < 1.0 and total > 0
    assert tw2v._keep_probabilities(counts_sorted, 0) is None
    neg = counts_sorted.astype(np.float64) ** 0.75
    np.testing.assert_array_equal(tw2v._negative_probabilities(counts_sorted), neg / neg.sum())


@pytest.mark.parametrize("keep", [True, False])
def test_make_pairs_equal_jax(keep):
    c = corpus()
    kp = np.random.default_rng(1).random(40).astype(np.float32) if keep else None
    got = tw2v._make_pairs(c, 3, np.random.default_rng(5), kp)
    want = jw2v._make_pairs(c, 3, np.random.default_rng(5), kp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_build_alias_equals_jax():
    rng = np.random.default_rng(3)
    probs = rng.random(257) ** 2 + 1e-9
    probs /= probs.sum()
    for p in (probs, np.asarray([1.0]), np.full(8, 1 / 8)):
        got, want = tw2v._build_alias(p), jw2v._build_alias(p)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_device_pair_slab_equals_jax_given_its_draws():
    """The compute half of the slab fed JAX's own keep / reduced-window
    draws (``_device_pair_slab``'s split key) gives JAX's layout and mask."""
    rng = np.random.default_rng(2)
    Rb, L, window, V = 5, 11, 3, 23
    toks = rng.integers(0, V, (Rb, L)).astype(np.int32)
    row_valid = np.array([True, True, True, False, True])
    keep_prob = rng.random(V).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jw2v._device_pair_slab(jnp.asarray(toks), jnp.asarray(row_valid), key,
                                  jnp.asarray(keep_prob), window)
    k_keep, k_red = jax.random.split(key)
    keep = np.array(jax.random.uniform(k_keep, (Rb, L)) < keep_prob[toks])
    red = np.array(jax.random.randint(k_red, (Rb, L), 0, window))
    got = tw2v._device_pair_slab(torch.from_numpy(toks), torch.from_numpy(row_valid),
                                 torch.from_numpy(keep), torch.from_numpy(red), window)
    assert got[0].shape[0] == Rb * tw2v._pair_slots_per_row(L, window)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < float(got[2].sum()) < got[2].numel()


def test_device_slab_mask_matches_make_pairs():
    """Given the same keeps and reduced windows, the slab's surviving
    (center, context) pairs are ``_make_pairs``' pairs as a multiset."""
    c = corpus(rows=6)
    kp = np.random.default_rng(1).random(40).astype(np.float32)
    pc, px = tw2v._make_pairs(c, 3, np.random.default_rng(4), kp)
    draws = np.random.default_rng(4)
    keep = draws.random(c.shape) < kp[c]
    red = draws.integers(0, 3, c.shape)
    cen, ctx, m = tw2v._device_pair_slab(torch.from_numpy(c), torch.ones(6, dtype=torch.bool),
                                         torch.from_numpy(keep), torch.from_numpy(red), 3)
    m = m.numpy().astype(bool)
    got = sorted(zip(cen.numpy()[m].tolist(), ctx.numpy()[m].tolist()))
    assert got == sorted(zip(pc.tolist(), px.tolist()))


def test_alias_negatives_equal_jax():
    rng = np.random.default_rng(4)
    probs = rng.random(50) ** 3
    alias, thresh = tw2v._build_alias(probs / probs.sum())
    cell = jax.random.randint(jax.random.PRNGKey(1), (64, 5), 0, 50)
    u = jax.random.uniform(jax.random.PRNGKey(2), (64, 5))
    want = jnp.where(u < jnp.asarray(thresh)[cell], cell, jnp.asarray(alias)[cell])
    got = tw2v._alias_negatives(torch.from_numpy(np.array(cell)),
                                torch.from_numpy(np.array(u)), torch.from_numpy(alias),
                                torch.from_numpy(thresh))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slab_draws_and_negative_draws_rates():
    gen = torch.Generator().manual_seed(3)
    toks = torch.zeros((200, 127), dtype=torch.int32)
    keep, red = tw2v._slab_draws(toks, torch.tensor([0.3]), 3, gen)
    assert abs(float(keep.float().mean()) - 0.3) < 0.01
    assert red.dtype == torch.int32 and set(red.unique().tolist()) == {0, 1, 2}
    probs = np.array([0.5, 0.25, 0.125, 0.125])
    alias, thresh = (torch.from_numpy(a) for a in tw2v._build_alias(probs))
    cell, u = tw2v._negative_draws(100_000, 5, 4, gen, "cpu")
    neg = tw2v._alias_negatives(cell, u, alias, thresh)
    freq = np.bincount(neg.numpy().ravel(), minlength=4) / neg.numel()
    np.testing.assert_allclose(freq, probs, atol=0.005)


# ---------------------------------------------------------------------------
# the updates
# ---------------------------------------------------------------------------

def step_inputs(seed=0, V=13, D=8, B=48, K=3):
    """A batch where rows repeat many times: B = 48 pairs over 13 rows."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, D)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32),
            rng.integers(0, V, B).astype(np.int32), rng.integers(0, V, B).astype(np.int32),
            rng.integers(0, V, (B, K)).astype(np.int32),
            (rng.random(B) < 0.6).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_sgd_core_matches_jax(masked):
    syn0, syn1, c, x, neg, mask = step_inputs()
    lr = np.float32(0.05)
    want = jw2v._sgd_core(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
                          jnp.asarray(x), jnp.asarray(neg), lr,
                          jnp.asarray(mask) if masked else None)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    got = tw2v._sgd_core(t0, t1, torch.from_numpy(c), torch.from_numpy(x),
                         torch.from_numpy(neg), float(lr),
                         torch.from_numpy(mask) if masked else None)
    assert got[0] is t0 and got[1] is t1          # in place
    for a, b, before in zip(got, want, (syn0, syn1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        assert np.abs(a.numpy() - before).max() > 1e-3


def test_cbow_step_matches_jax():
    syn0, syn1, c, _, neg, _ = step_inputs(seed=1)
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, 13, (48, 4)).astype(np.int32)
    cmask = (rng.random((48, 4)) < 0.7).astype(np.float32)
    cmask[0] = 0.0                                       # a row without context
    lr = np.float32(0.05)
    want = jw2v._cbow_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(ctx),
                           jnp.asarray(cmask), jnp.asarray(c), jnp.asarray(neg), lr)
    got = tw2v._cbow_step(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                          torch.from_numpy(ctx), torch.from_numpy(cmask), torch.from_numpy(c),
                          torch.from_numpy(neg), float(lr))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_masked_step_equals_compacted_step():
    """A masked batch updates exactly like its compacted survivors; an
    all-masked batch changes nothing."""
    syn0, syn1, c, x, neg, mask = step_inputs(seed=2)
    keep = mask.astype(bool)
    t = [torch.from_numpy(a) for a in (c, x, neg)]
    m0, m1 = tw2v._sgd_core(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                            *t, 0.05, torch.from_numpy(mask))
    c0, c1 = tw2v._sgd_core(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                            *(torch.from_numpy(a[keep]) for a in (c, x, neg)), 0.05)
    np.testing.assert_allclose(m0.numpy(), c0.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(m1.numpy(), c1.numpy(), atol=1e-6, rtol=1e-6)
    z0, z1 = tw2v._sgd_core(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                            *t, 0.05, torch.zeros(len(c)))
    np.testing.assert_array_equal(z0.numpy(), syn0)
    np.testing.assert_array_equal(z1.numpy(), syn1)


def test_scatter_mean_of_duplicates():
    """One row hit n times moves by the mean of its n contributions."""
    table = torch.zeros(4, 2)
    idx = torch.tensor([1, 1, 1, 3], dtype=torch.int32)
    grads = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    tw2v._scatter_mean_add(table, idx, grads)
    np.testing.assert_allclose(table.numpy(), [[0, 0], [3, 4], [0, 0], [7, 8]])


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sg", [True, False])
def test_train_word2vec_matches_jax(sg, monkeypatch):
    jax_syn0(monkeypatch)
    g = twalker.CSRGraph.from_edges(*chord_edges(40))
    walks = twalker.random_walks(g, walk_len=12, epochs=3, seed=0)
    kw = dict(dim=16, window=3, negative=4, iterations=2, seed=3, sample=1e-2, sg=sg,
              batch_pairs=256, index_to_name=g.names)
    got = tw2v.train_word2vec(walks, g.n_nodes, device="cpu", **kw)
    want = jw2v.train_word2vec(walks, g.n_nodes, **kw)
    assert got.index_to_word == want.index_to_word
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.vectors.dtype == np.float32
    np.testing.assert_allclose(got.vectors, want.vectors, atol=RUN_ATOL, rtol=0)
    assert np.abs(got.vectors - np.asarray(tw2v._init_syn0(40, 16, 3, "cpu"))[
        np.argsort(-np.bincount(walks.ravel(), minlength=40), kind="stable")]).max() > 1e-2


def ring_quality(res, n=20):
    row = {name: i for i, name in enumerate(res.index_to_word)}
    v = res.vectors / np.linalg.norm(res.vectors, axis=1, keepdims=True)
    near = np.mean([v[row[f"n{i}"]] @ v[row[f"n{(i + 1) % n}"]] for i in range(n)])
    far = np.mean([v[row[f"n{i}"]] @ v[row[f"n{(i + 10) % n}"]] for i in range(n)])
    return near, far


def test_device_pipeline_learns_structure():
    """``tests/test_node2vec.py``'s ring assertion, on the port's device
    pipeline (one-row slabs, as there)."""
    g = twalker.CSRGraph.from_edges(*ring_edges(20))
    walks = twalker.random_walks(g, walk_len=30, epochs=30, seed=0)
    res = tw2v.train_word2vec(walks, g.n_nodes, dim=16, window=3, negative=5, iterations=2,
                              seed=0, sample=0, alpha=0.05, batch_pairs=128,
                              index_to_name=g.names, device_pipeline=True, device="cpu")
    near, far = ring_quality(res)
    assert near > far + 0.15, (near, far)


def test_device_pipeline_independent_of_dispatch():
    g = twalker.CSRGraph.from_edges(*ring_edges(20))
    walks = twalker.random_walks(g, walk_len=10, epochs=4, seed=0)
    runs = [tw2v.train_word2vec(walks, g.n_nodes, dim=8, seed=2, batch_pairs=300,
                                device_pipeline=True, slabs_per_dispatch=n, device="cpu")
            for n in (1, 32)]
    np.testing.assert_array_equal(runs[0].vectors, runs[1].vectors)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tw2v.train_word2vec(np.zeros((2, 3), np.int32), 1, dim=4)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def test_run_node2vec_artifacts_match_jax(tmp_path, monkeypatch):
    jax_syn0(monkeypatch)
    src, tgt = chord_edges(45)
    # the pre-training TSV as the extraction writes it; BEL names with quotes
    src = [f'a(CHEBI:"{s}")' if i % 5 == 0 else s for i, s in enumerate(src)]
    df = pd.DataFrame({"source": src, "relation": "increases", "target": tgt,
                       "evidence": "x\ty"})
    path = tmp_path / "pretraining_triples.tsv"
    df.to_csv(path, sep="\t", index=False)
    kw = dict(dimensions=8, walk_length=9, epochs=2, seed=1)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jres, jwalks, _ = jn2v.run_node2vec(pretraining_path=str(path), output_dir=str(tmp_path / "j"),
                                        **kw)
    res, walks, graph = tn2v.run_node2vec(pretraining_path=str(path),
                                          output_dir=str(tmp_path / "t"), device="cpu", **kw)
    np.testing.assert_array_equal(walks, jwalks)
    names = ("embeddings_best_model.tsv", "random_walks_best_model.tsv")
    emb, jemb = (tmp_path / d / names[0] for d in ("t", "j"))
    rw, jrw = (tmp_path / d / names[1] for d in ("t", "j"))
    assert rw.read_bytes() == jrw.read_bytes()
    rows = [line.split("\t") for line in emb.read_text().splitlines()]
    jrows = [line.split("\t") for line in jemb.read_text().splitlines()]
    assert [r[0] for r in rows] == [r[0] for r in jrows] == res.index_to_word
    np.testing.assert_allclose(np.array([r[1:] for r in rows], float),
                               np.array([r[1:] for r in jrows], float), atol=RUN_ATOL)
    # the bytes are repr of each float32 value
    assert rows[0][1:] == [repr(float(v)) for v in res.vectors[0]]
    art = load_kg_artifacts(emb, rw)
    assert art.n_entities == graph.n_nodes == len(set(src) | set(tgt)) and art.rw_len == 9
    np.testing.assert_array_equal(art.vectors, res.vectors)
    # the quirk: row k pairs the k-th most frequent node with walk k
    first = rw.read_text().splitlines()[0].split("\t")
    assert first[0] == res.index_to_word[0] and first[1] == graph.names[0]


# ---------------------------------------------------------------------------
# link prediction and HPO
# ---------------------------------------------------------------------------

def test_edge_split_equals_jax():
    g = twalker.CSRGraph.from_edges(*chord_edges())
    jg = jwalker.CSRGraph.from_edges(*chord_edges())
    for frac, seed in ((0.1, 0), (0.5, 3)):
        for a, b in zip(tn2v.split_edges_for_link_prediction(g, frac, seed),
                        jn2v.split_edges_for_link_prediction(jg, frac, seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,seed", [(18, 0), (31, 4), (200, 7)])
def test_train_test_split_equals_sklearn(n, seed):
    labels = np.concatenate([np.ones(n // 2 + n % 2), np.zeros(n // 2)])
    idx = np.arange(n)
    want_tr, want_te = train_test_split(idx, stratify=labels, random_state=seed)
    tr, te = tn2v._train_test_split(labels, seed)
    np.testing.assert_array_equal(tr, want_tr)
    np.testing.assert_array_equal(te, want_te)


@pytest.mark.parametrize("d,n", [(8, 120), (32, 400), (64, 1000)])
def test_logistic_regression_matches_sklearn(d, n):
    """The unique minimiser: scikit-learn's lbfgs solved to convergence
    (``tol=1e-10``; its default ``tol=1e-4`` stops 2.7e-4 to 1.2e-3
    relative short of it on these data) within 1e-4 relative, and the
    same predictions."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0.3).astype(np.float64)
    coef, intercept = tn2v._fit_logistic(x, y)
    clf = LogisticRegression(max_iter=1000, tol=1e-10).fit(x, y)
    want = np.concatenate([clf.coef_[0], clf.intercept_])
    got = np.concatenate([coef, [intercept]])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(((x @ coef + intercept) > 0).astype(float), clf.predict(x))


def test_roc_auc_equals_sklearn():
    rng = np.random.default_rng(0)
    for _ in range(20):
        y = rng.integers(0, 2, 50).astype(float)
        y[:2] = [0, 1]
        hard = rng.integers(0, 2, 50).astype(float)
        soft = np.round(rng.random(50), 1)           # ties
        for score in (hard, soft, np.zeros(50)):
            assert tn2v._roc_auc(y, score) == roc_auc_score(y, score)


def test_link_prediction_equals_jax_on_equal_vectors():
    src, tgt = chord_edges(90)
    g, jg = twalker.CSRGraph.from_edges(src, tgt), jwalker.CSRGraph.from_edges(src, tgt)
    walks = twalker.random_walks(g, walk_len=30, epochs=20, seed=0)
    res = jw2v.train_word2vec(walks, g.n_nodes, dim=16, window=3, iterations=2, seed=0,
                              sample=0, alpha=0.05, batch_pairs=128, index_to_name=g.names)
    port_res = tw2v.Word2VecResult(res.vectors, res.index_to_word, res.counts)
    for seed, frac in ((0, 0.5), (2, 0.3)):
        got = tn2v.run_link_prediction(g, port_res, seed=seed, frac=frac)
        assert got == jn2v.run_link_prediction(jg, res, seed=seed, frac=frac)
    assert got > 0.6


def test_hpo_grid_equals_jax(tmp_path, monkeypatch):
    """optuna hidden: the JAX package's (epochs, window) trials in its
    order, the best trial's AUC and files.  (The AUCs themselves are not
    compared: on a graph this small one prediction near the boundary
    moves them, and scikit-learn's default lbfgs stops short of the
    minimiser, see ``test_logistic_regression_matches_sklearn``.)"""
    monkeypatch.setitem(sys.modules, "optuna", None)
    jax_syn0(monkeypatch)
    src, tgt = chord_edges(60)
    df = pd.DataFrame({"source": src, "target": tgt})
    seen = {"t": [], "j": []}
    out = {}
    kw = dict(n_trials=4, seed=0, dimensions=8, walk_length=12)
    for tag, fn, extra in (("j", jn2v.run_node2vec_hpo, {}),
                           ("t", tn2v.run_node2vec_hpo, {"device": "cpu"})):
        (tmp_path / tag).mkdir()
        out[tag] = fn(df, output_dir=str(tmp_path / tag), logger_fn=seen[tag].append, **kw,
                      **extra)
    trials = [(t["epochs"], t["window"]) for t in seen["t"]]
    assert trials == [(t["epochs"], t["window"]) for t in seen["j"]]
    assert trials == [(2, 3), (2, 4), (2, 5), (4, 3)]
    best = max(seen["t"], key=lambda t: t["auc"])
    assert out["t"] == {"best_auc": best["auc"], "n_trials": 4,
                        "best_params": {"epochs": best["epochs"], "window": best["window"]}}
    emb = tmp_path / "t" / "embeddings_best_model.tsv"
    walks = tmp_path / "t" / "random_walks_best_model.tsv"
    art = load_kg_artifacts(emb, walks)
    assert art.n_entities == 60 and art.rw_len == 12
    # the best trial's walks: the walker's rows for its epochs
    g = twalker.CSRGraph.from_edges(src, tgt)
    first = walks.read_text().splitlines()[0].split("\t")[1:]
    w = twalker.random_walks(g, walk_len=12, epochs=best["epochs"], seed=0)
    assert first == [g.names[i] for i in w[0]]
