"""The port's data modules against the JAX package's, on the CPU.

Tokenizers, KG artifacts, masking and the three preprocessing families
(STonKGs, TransE, ProtSTonKGs) get the same inputs in both packages
(files written in ``tmp_path``, arrays from a numpy seed); every token,
id, name and array must be equal, the vectors bit for bit.
"""

import random

import numpy as np
import pytest

from stonkgs_tpu.data import artifacts as jart
from stonkgs_tpu.data import fast_tokenizer as jfast
from stonkgs_tpu.data import masking as jmask
from stonkgs_tpu.data import preprocessing as jpre
from stonkgs_tpu.data import prot as jprot
from stonkgs_tpu.data import transe as jtranse
from stonkgs_tpu.data import wordpiece as jwp
from stonkgs_tpu_torch.data import artifacts as tart
from stonkgs_tpu_torch.data import fast_tokenizer as tfast
from stonkgs_tpu_torch.data import masking as tmask
from stonkgs_tpu_torch.data import preprocessing as tpre
from stonkgs_tpu_torch.data import prot as tprot
from stonkgs_tpu_torch.data import transe as ttranse
from stonkgs_tpu_torch.data import wordpiece as twp

from test_fast_tokenizer import TEXTS as FAST_TEXTS
from test_fast_tokenizer import VOCAB as FAST_VOCAB
from test_tokenizer import SENTENCES, VOCAB

LM_VOCAB = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
            "alpha", "beta", "gamma", "activates", "inhibits", "q", "##s", "cdh"]
PROT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "a", "c", "d", "e", "f", "g"]


def bel_names(n):
    """BEL-style node names: spaces, '!', parentheses, quotes, colons."""
    kinds = ("p(HGNC:{i} ! GENE{i})", 'a(CHEBI:"compound {i}")',
             'bp(GO:"cell death {i}")', "complex(p(HGNC:{i}), p(HGNC:{j}))")
    return [kinds[i % 4].format(i=i, j=i + 1) for i in range(n)]


def _vocab(tmp_path_factory, name, tokens):
    p = tmp_path_factory.mktemp(name) / "vocab.txt"
    p.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return str(p)


@pytest.fixture(scope="module")
def lm_vocab(tmp_path_factory):
    return _vocab(tmp_path_factory, "lm", LM_VOCAB)


@pytest.fixture(scope="module")
def prot_vocab(tmp_path_factory):
    return _vocab(tmp_path_factory, "prot", PROT_VOCAB)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wp_pair(tmp_path_factory):
    vocab = _vocab(tmp_path_factory, "wp", VOCAB)
    return jwp.BertTokenizer(vocab), twp.BertTokenizer(vocab)


@pytest.mark.parametrize("text", SENTENCES)
def test_wordpiece_matches_jax(wp_pair, text):
    jt, tt = wp_pair
    assert tt.tokenize(text) == jt.tokenize(text)
    for max_length in (6, 12, 16):
        assert tt.encode(text, max_length) == jt.encode(text, max_length)
    assert (tt.cls_id, tt.sep_id, tt.pad_id, tt.unk_id, tt.mask_id, tt.vocab_size) == \
        (jt.cls_id, jt.sep_id, jt.pad_id, jt.unk_id, jt.mask_id, jt.vocab_size)


@pytest.fixture(scope="module")
def fast_pair(tmp_path_factory):
    vocab = _vocab(tmp_path_factory, "fast", FAST_VOCAB)
    port = tfast.FastBertTokenizer(vocab)
    assert port.is_native, "the port's C++ tokenizer did not build"
    return jfast.FastBertTokenizer(vocab), port, twp.BertTokenizer(vocab)


@pytest.mark.parametrize("max_length", [3, 8, 16, 64])
def test_fast_tokenizer_matches_jax_and_python(fast_pair, max_length):
    jt, tt, py = fast_pair
    ids, mask = tt.encode_batch(FAST_TEXTS, max_length)
    jids, jmask_ = jt.encode_batch(FAST_TEXTS, max_length)
    pids, pmask = py.encode_batch(FAST_TEXTS, max_length)
    assert ids.dtype == np.int32 and ids.shape == (len(FAST_TEXTS), max_length)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask_)
    np.testing.assert_array_equal(ids, pids)
    np.testing.assert_array_equal(mask, pmask)
    for text in FAST_TEXTS:
        assert tt.tokenize(text) == jt.tokenize(text)   # the Python surface
    assert (tt.cls_id, tt.sep_id, tt.pad_id, tt.unk_id, tt.mask_id, tt.vocab_size) == \
        (jt.cls_id, jt.sep_id, jt.pad_id, jt.unk_id, jt.mask_id, jt.vocab_size)


def test_fast_tokenizer_python_fallback_matches(monkeypatch, fast_pair):
    _, tt, py = fast_pair
    monkeypatch.setattr(tfast, "_lib", None)
    monkeypatch.setattr(tfast, "_lib_failed", True)
    slow = tfast.FastBertTokenizer(tt._vocab_file)
    assert not slow.is_native
    np.testing.assert_array_equal(slow.encode_batch(FAST_TEXTS, 16)[0],
                                  py.encode_batch(FAST_TEXTS, 16)[0])


# ---------------------------------------------------------------------------
# KG artifacts
# ---------------------------------------------------------------------------

def _random_artifacts(mod, names, dim=6, rw_len=5, seed=0):
    a = mod.make_random_artifacts(len(names), dim=dim, rw_len=rw_len, seed=seed)
    a.names = list(names)
    a.name_to_idx = {n: i for i, n in enumerate(names)}
    return a


@pytest.fixture(scope="module")
def kg_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("kg")
    art = _random_artifacts(tart, bel_names(40))
    tart.save_kg_artifacts(art, root / "emb.tsv", root / "walks.tsv")
    return art, str(root / "emb.tsv"), str(root / "walks.tsv")


def _assert_artifacts_equal(got, want):
    assert got.names == want.names
    assert got.name_to_idx == want.name_to_idx
    assert got.rw_len == want.rw_len
    assert got.vectors.dtype == np.float32 and want.vectors.dtype == np.float32
    assert got.vectors.tobytes() == want.vectors.tobytes()
    np.testing.assert_array_equal(got.walk_indices, want.walk_indices)
    assert got.walk_indices.dtype == want.walk_indices.dtype


def test_load_kg_artifacts_matches_jax(kg_files):
    art, emb, walks = kg_files
    got, want = tart.load_kg_artifacts(emb, walks), jart.load_kg_artifacts(emb, walks)
    _assert_artifacts_equal(got, want)
    assert got.vectors.tobytes() == art.vectors.tobytes()   # written and read exactly
    probe = np.asarray(art.names[:5] + ["p(HGNC:999 ! MISSING)", "node1"], object)
    for unk in (100, 7):
        np.testing.assert_array_equal(got.walks_for(probe, unk), want.walks_for(probe, unk))


def test_load_kg_artifacts_reads_the_jax_writer_and_shuffled_walks(tmp_path, kg_files):
    art = kg_files[0]
    jart.save_kg_artifacts(art, tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    # walks in another order than the embeddings, CRLF line ends, a blank line
    lines = (tmp_path / "walks.tsv").read_text().splitlines()
    order = np.random.default_rng(3).permutation(len(lines))
    (tmp_path / "walks.tsv").write_bytes(
        ("\r\n".join(lines[i] for i in order) + "\r\n\r\n").encode())
    _assert_artifacts_equal(
        tart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "walks.tsv"),
        jart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "walks.tsv"))


def test_names_pandas_would_convert_are_kept_verbatim(tmp_path):
    """Pins the one difference from the JAX loader: pandas reads ``NA``,
    ``null`` and ``nan`` as NaN (``"nan"`` after ``str``); the port keeps
    every name as the file spells it.  Other names agree."""
    names = ["NA", "null", "nan", "1e3", "p(HGNC:1748 ! CDH1)", "#1", "01"]
    art = _random_artifacts(tart, names, rw_len=3, seed=2)
    tart.save_kg_artifacts(art, tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    got = tart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    want = jart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    assert got.names == names
    assert want.names == ["nan", "nan", "nan"] + names[3:]
    np.testing.assert_array_equal(got.walk_indices, art.walk_indices)
    assert got.vectors.tobytes() == want.vectors.tobytes()
    np.testing.assert_array_equal(got.walks_for(np.asarray(["NA"], object), 100)[0],
                                  art.walk_indices[0])
    assert (want.walks_for(np.asarray(["NA"], object), 100) == 100).all()


def test_load_kg_artifacts_rejects_mismatched_files(tmp_path, kg_files):
    art = kg_files[0]
    tart.save_kg_artifacts(art, tmp_path / "emb.tsv", tmp_path / "walks.tsv")
    lines = (tmp_path / "walks.tsv").read_text().splitlines()
    (tmp_path / "short.tsv").write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="same entities"):
        tart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "short.tsv")
    fields = lines[0].split("\t")
    (tmp_path / "stray.tsv").write_text(
        "\n".join(["\t".join(fields[:1] + ["p(HGNC:0 ! NONE)"] + fields[2:])]
                  + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="no embedding"):
        tart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "stray.tsv")
    lines[0] += "\textra"
    (tmp_path / "ragged.tsv").write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="unequal length"):
        tart.load_kg_artifacts(tmp_path / "emb.tsv", tmp_path / "ragged.tsv")


def test_load_transe_artifacts_matches_jax(tmp_path):
    names = bel_names(12) + ["increases", "decreases"]
    vecs = np.random.default_rng(4).normal(size=(len(names), 8)).astype(np.float32)
    with open(tmp_path / "transe.tsv", "w") as f:
        for n, v in zip(names, vecs):
            f.write(n + "\t" + "\t".join(repr(float(x)) for x in v) + "\n")
    got = ttranse.load_transe_artifacts(tmp_path / "transe.tsv")
    want = jtranse.load_transe_artifacts(tmp_path / "transe.tsv")
    assert got.names == want.names == names
    assert got.name_to_idx == want.name_to_idx
    assert got.vectors.tobytes() == want.vectors.tobytes() == vecs.tobytes()


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,vocab", [((5, 40), 28), ((3, 4), 9), ((7, 259), 1000)])
def test_mask_tokens_matches_jax(shape, vocab):
    tokens = np.random.default_rng(0).integers(0, vocab, shape)
    got = tmask.mask_tokens(tokens, vocab, np.random.default_rng(11), mask_id=5)
    want = jmask.mask_tokens(tokens, vocab, np.random.default_rng(11), mask_id=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_add_negative_nsp_samples_and_replace_mlm_tokens_match_jax():
    rng = np.random.default_rng(1)
    n, half = 12, 6
    feats = {
        "input_ids": rng.integers(0, 50, (n, 2 * half)),
        "attention_mask": rng.integers(0, 2, (n, 2 * half)),
        "token_type_ids": np.repeat([[0] * half + [1] * half], n, 0),
        "masked_lm_labels": rng.integers(-100, 50, (n, half)),
        "ent_masked_lm_labels": rng.integers(-100, 50, (n, half)),
        "next_sentence_labels": np.zeros(n, np.int64),
    }
    got = tmask.add_negative_nsp_samples(feats, np.random.default_rng(2), 0.25, half)
    want = jmask.add_negative_nsp_samples(feats, np.random.default_rng(2), 0.25, half)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tokens = list(range(20, 60))
    random.seed(3)
    got = tmask.replace_mlm_tokens(tokens, 70)
    random.seed(3)
    assert got == jmask.replace_mlm_tokens(tokens, 70)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def _assert_features_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def kg_pair(kg_files):
    _, emb, walks = kg_files
    return jart.load_kg_artifacts(emb, walks), tart.load_kg_artifacts(emb, walks)


def _rows(names, n, seed):
    rng = np.random.default_rng(seed)
    words = LM_VOCAB[6:] + ["cdhs", "unknownword", "ALPHA"]
    ev = [" ".join(rng.choice(words, rng.integers(0, 20))) for _ in range(n)]
    src = [names[i] for i in rng.integers(0, len(names), n)]
    tgt = [names[i] for i in rng.integers(0, len(names), n)]
    src[1] = "p(HGNC:0 ! NOT_IN_KG)"   # an unknown node takes the UNK walk
    return np.asarray(src, object), np.asarray(tgt, object), ev


@pytest.mark.parametrize("kind", ["embeddings", "embeddings_unmasked", "finetuning",
                                  "pretraining", "indices"])
def test_preprocess_matches_jax(kind, kg_pair, lm_vocab):
    jkg, tkg = kg_pair
    jtok, ttok = jwp.BertTokenizer(lm_vocab), tfast.FastBertTokenizer(lm_vocab)
    src, tgt, ev = _rows(tkg.names, 9, seed=5)
    if kind == "indices":
        idx = np.random.default_rng(6).integers(0, tkg.n_entities, (2, 9))
        _assert_features_equal(
            tpre.preprocess_for_embeddings(idx[0], idx[1], ev, tkg, ttok, seed=2),
            jpre.preprocess_for_embeddings(idx[0], idx[1], ev, jkg, jtok, seed=2))
    elif kind.startswith("embeddings"):
        kw = dict(apply_masking=kind == "embeddings", seed=4)
        _assert_features_equal(
            tpre.preprocess_for_embeddings(src, tgt, ev, tkg, ttok, **kw),
            jpre.preprocess_for_embeddings(src, tgt, ev, jkg, jtok, **kw))
    elif kind == "finetuning":
        labels = np.arange(9) % 3
        _assert_features_equal(
            tpre.preprocess_for_finetuning(src, tgt, ev, labels, tkg, ttok),
            jpre.preprocess_for_finetuning(src, tgt, ev, labels, jkg, jtok))
    else:
        _assert_features_equal(
            tpre.preprocess_for_pretraining(src, tgt, ev, tkg, ttok, seed=8),
            jpre.preprocess_for_pretraining(src, tgt, ev, jkg, jtok, seed=8))


def test_transe_preprocessing_matches_jax(lm_vocab):
    names = bel_names(10) + ["increases", "decreases"]
    vecs = np.random.default_rng(0).normal(size=(12, 8)).astype(np.float32)
    jt = jtranse.TransEArtifacts(names, {n: i for i, n in enumerate(names)}, vecs)
    tt = ttranse.TransEArtifacts(names, {n: i for i, n in enumerate(names)}, vecs)
    jtok, ttok = jwp.BertTokenizer(lm_vocab), tfast.FastBertTokenizer(lm_vocab)
    n = 10
    src = [names[i % 10] for i in range(n)]
    rel = ["increases", "decreases"] * (n // 2)
    tgt = [names[(3 * i) % 10] for i in range(n)]
    src[4] = "p(HGNC:0 ! NOT_IN_KG)"          # skipped and counted
    ev = [" ".join(["alpha", "activates", "beta"][: i % 4]) for i in range(n)]
    got_part, want_part = (ttranse.assemble_transe_part(src, rel, tgt, tt),
                           jtranse.assemble_transe_part(src, rel, tgt, jt))
    for g, w in zip(got_part, want_part):
        np.testing.assert_array_equal(g, w)
    (got, gskip) = ttranse.preprocess_transe_for_pretraining(
        src, rel, tgt, ev, tt, ttok, text_part_length=12, seed=3)
    (want, wskip) = jtranse.preprocess_transe_for_pretraining(
        src, rel, tgt, ev, jt, jtok, text_part_length=12, seed=3)
    assert gskip == wskip == 1
    _assert_features_equal(got, want)
    labels = np.arange(n) % 2
    _assert_features_equal(
        ttranse.preprocess_transe_for_finetuning(src, rel, tgt, ev, labels, tt, ttok,
                                                 text_part_length=12),
        jtranse.preprocess_transe_for_finetuning(src, rel, tgt, ev, labels, jt, jtok,
                                                 text_part_length=12))


@pytest.mark.parametrize("finetuning", [False, True])
def test_prot_preprocessing_matches_jax(finetuning, kg_pair, lm_vocab, prot_vocab):
    jkg, tkg = kg_pair
    jl, tl = jwp.BertTokenizer(lm_vocab), tfast.FastBertTokenizer(lm_vocab)
    jp = jwp.BertTokenizer(prot_vocab, do_lower_case=False)
    tp = tfast.FastBertTokenizer(prot_vocab, do_lower_case=False)
    src, tgt, ev = _rows(tkg.names, 4, seed=9)
    rows = {"source": list(src), "target": list(tgt), "evidence": ev,
            "source_description": ["alpha q", "beta", "", "gamma inhibits cdhs"],
            "target_description": ["gamma", "alpha", "q q q", "beta"],
            "source_prot": ["a c d e", "f g a", "", "c c c c c c c c c c"],
            "target_prot": ["g f", "a c", "x", "e"]}
    kw = dict(text_seq_length=24, prot_seq_length=16, bigbird_sep_id=7,
              bigbird_mask_id=8)
    if finetuning:
        labels = np.arange(4) % 2
        got = tprot.preprocess_prot_for_finetuning(rows, labels, tkg, tl, tp, **kw)
        want = jprot.preprocess_prot_for_finetuning(rows, labels, jkg, jl, jp, **kw)
    else:
        got = tprot.preprocess_prot_for_pretraining(rows, tkg, tl, tp, seed=5, **kw)
        want = jprot.preprocess_prot_for_pretraining(rows, jkg, jl, jp, seed=5, **kw)
    _assert_features_equal(got, want)
