"""The port's parallelism against the JAX package, on the CPU with gloo ranks.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs on ranks spawned once a world size for the whole module
(``stonkgs_tpu_torch.parallel.multihost.launch``, gloo, one thread a rank),
each running many cases (``tests/_torch_parallel_ranks.py``).  The same
numpy weights (JAX ``init_*`` -> ``params_from_jax``) and rows go through
both.  Covered:

* the spec rules, the FSDP choice and the padding against
  ``_tree_paths_and_specs`` and ``pad_params_for_mesh``, leaf for leaf,
  for the STonKGs, TransE and ProtSTonKGs trees on 2x2, 4x1 and 1x2;
* ``tp_gather`` on 2 and 3 model ranks: equal to ``jnp.take`` and JAX's
  ``tp_gather``; ``tp_masked_cross_entropy``: the loss and its gradients
  with respect to the hidden states and the kernel within 1e-5 relative
  of JAX's and of the dense ``masked_cross_entropy``;
* two sharded train steps (fp32, dropout 0, masked counts that differ
  across rows and shards, the clip at 0.5 active) on 1x2, 2x2 and 4x1
  with FSDP, and ProtSTonKGs on 1x2, against JAX's single-device
  ``make_train_step``: losses within ``rtol=1e-5``, parameters within
  ``PARAM_TOL``;
* dropout on: ranks of one data index hold bit-equal replicated leaves
  and moments; a 1x1 mesh is the unmeshed ``pretrain`` bit for bit;
* a 2x2 run stopped at step 2 and resumed equals the uninterrupted run bit
  for bit, and its checkpoint loads in a single process;
* ``multihost`` on gloo ranks, ``train_classifier`` on 2x1 against JAX's
  on a 2x1 mesh, ``run_pretraining(n_model_shards=2)`` on 2 ranks against
  one process, and ``dryrun_multichip(4)``.
"""

import dataclasses
import functools
import json
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import heads as jheads
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.models import stonkgs as jstonkgs
from stonkgs_tpu.ops.losses import masked_cross_entropy as jax_masked_ce
from stonkgs_tpu.parallel import mesh as jmesh
from stonkgs_tpu.parallel import tp as jtp
from stonkgs_tpu.train import finetuning as jft
from stonkgs_tpu.train import pretraining as jpre
from stonkgs_tpu.train.optimizer import make_optimizer
from stonkgs_tpu_torch.cli import pretrain as tcli
from stonkgs_tpu_torch.data import memmap_dataset as tmem
from stonkgs_tpu_torch.parallel import dryrun, multihost
from stonkgs_tpu_torch.parallel import mesh as tmesh
from stonkgs_tpu_torch.train import checkpoint as tckpt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.train.optimizer import AdamW, split_frozen
from stonkgs_tpu_torch.utils.convert import params_from_jax, protstonkgs_params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path

import _torch_parallel_ranks as ranks

# updated parameters: both frameworks sum in another order, and a sharded
# step sums over ranks in another order again
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)

BERT = jconfig.BertConfig(
    vocab_size=131, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0)
CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=151, text_len=16, entity_len=16)
TRANSE_CFG = jconfig.STonKGsConfig(bert=BERT, kg_vocab_size=151, text_len=16, entity_len=4)


def _small_bert(**kw):
    return jconfig.BertConfig(num_hidden_layers=1, num_attention_heads=2, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **kw)


PROT_CFG = jconfig.ProtSTonKGsConfig(
    trunk=jconfig.BigBirdConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, block_size=4, num_random_blocks=1,
        attention_type="block_sparse", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0),
    lm=_small_bert(vocab_size=131, hidden_size=32, intermediate_size=64,
                   max_position_embeddings=8),
    prot=_small_bert(vocab_size=30, hidden_size=16, intermediate_size=32,
                     max_position_embeddings=16),
    lm_vocab_size=131, kg_vocab_size=151, prot_vocab_size=30, kg_start_idx=12,
    prot_start_idx=16, seq_len=32, sep_id=102, mask_id=103, unk_id=100)

_LAYER = re.compile(r"^(.*/encoder)/(\d+)/(.*)$")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread in this process, as in the ranks: the CPU's
    multi-threaded accumulating index_put (the embeddings' backward) adds
    in no fixed order, and the bit-for-bit comparisons need one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return ranks.prot_cfg(dataclasses.asdict(cfg)) if isinstance(
        cfg, jconfig.ProtSTonKGsConfig) else ranks.stonkgs_cfg(dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=0):
    key = jax.random.PRNGKey(seed)
    if isinstance(cfg, jconfig.ProtSTonKGsConfig):
        p = jprot.init_protstonkgs_params(key, cfg)
        h = cfg.trunk.hidden_size
    else:
        p = jstonkgs.init_stonkgs_params(key, cfg)
        h = cfg.bert.hidden_size
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(seed + 1), (cfg.kg_table_size, h))
    return jax.tree.map(np.asarray, p)


def _to_port(cfg, params_np):
    convert = protstonkgs_params_from_jax if isinstance(
        cfg, jconfig.ProtSTonKGsConfig) else params_from_jax
    return convert(params_np, _port(cfg))


def stonkgs_rows(cfg, n, seed):
    """Rows with text halves of random true length and 0 to 2 masked
    positions a half: the masked counts differ across rows and shards."""
    rng = np.random.default_rng(seed)
    tl, el = cfg.text_len, cfg.entity_len
    lengths = rng.integers(4, tl + 1, n)
    keep = np.arange(tl)[None, :] < lengths[:, None]
    mlm = np.full((n, tl), -100, np.int64)
    elm = np.full((n, el), -100, np.int64)
    for i in range(n):
        for labels, length, vocab in ((mlm, lengths[i], cfg.bert.vocab_size),
                                      (elm, el, cfg.kg_vocab_size)):
            k = int(rng.integers(0, 3))
            labels[i, rng.choice(length, k, replace=False)] = rng.integers(0, vocab, k)
    return {
        "input_ids": np.concatenate(
            [np.where(keep, rng.integers(4, cfg.bert.vocab_size, (n, tl)), 0),
             rng.integers(0, cfg.kg_vocab_size, (n, el))], 1),
        "attention_mask": np.concatenate([keep, np.ones((n, el), bool)], 1).astype(np.int64),
        "token_type_ids": np.concatenate([np.zeros((n, tl), np.int64),
                                          np.ones((n, el), np.int64)], 1),
        "masked_lm_labels": mlm,
        "ent_masked_lm_labels": elm,
        "next_sentence_labels": rng.integers(0, 2, n).astype(np.int64),
    }


def prot_rows(n, seed):
    """ProtSTonKGs rows with 0 to k masked positions a segment."""
    c = PROT_CFG
    rng = np.random.default_rng(seed)
    tl, el, pl = c.text_len, c.entity_len, c.prot_len
    out = {"input_ids": np.concatenate([rng.integers(0, c.lm_vocab_size, (n, tl)),
                                        rng.integers(0, c.kg_vocab_size, (n, el)),
                                        rng.integers(0, c.prot_vocab_size, (n, pl))], 1),
           "attention_mask": np.ones((n, c.seq_len), np.int64)}
    out["attention_mask"][::3, 25:] = 0
    for name, length, vocab in (("masked_lm_labels", tl, c.lm_vocab_size),
                                ("ent_masked_lm_labels", el, c.kg_vocab_size),
                                ("prot_masked_lm_labels", pl, c.prot_vocab_size)):
        labels = np.full((n, length), -100, np.int64)
        for i in range(n):
            k = int(rng.integers(0, max(int(length * 0.15), 1) + 1))
            labels[i, rng.choice(length, k, replace=False)] = rng.integers(0, vocab, k)
        out[name] = labels
    return out


# ---------------------------------------------------------------------------
# the JAX package's single-device references
# ---------------------------------------------------------------------------

def _jax_steps(cfg, params_np, batches, accum=1):
    """JAX's single-device ``make_train_step``: metrics a step and the
    trainable parameters in the port's layout."""
    tx = make_optimizer(None, learning_rate=ranks.LR, total_steps=ranks.TOTAL,
                        max_grad_norm=ranks.CLIP)
    state = jpre.init_train_state(jax.tree.map(jnp.asarray, params_np), tx)
    loss_fn = jprot.pretraining_loss if isinstance(cfg, jconfig.ProtSTonKGsConfig) else None
    step = jpre.make_train_step(cfg, tx, loss_fn=loss_fn, compute_dtype=jnp.float32,
                                grad_accumulation_steps=accum, donate=False)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    port = _to_port(cfg, jax.tree.map(np.asarray, state.params))
    return metrics, {k: v.numpy() for k, v in tree_flatten_with_path(split_frozen(port)[0]).items()}


def _jax_grad_norm(cfg, params_np, batch):
    """The global gradient norm of JAX's first step (the clip's input)."""
    jp = jax.tree.map(jnp.asarray, params_np)
    frozen = {k: v for k, v in jp.items() if k.endswith("backbone")}
    train = {k: v for k, v in jp.items() if k not in frozen}
    loss_fn = jprot.pretraining_loss if isinstance(cfg, jconfig.ProtSTonKGsConfig) \
        else jstonkgs.pretraining_loss

    @jax.jit
    def norm(t, b):
        g = jax.grad(lambda t: loss_fn({**t, **frozen}, cfg, b, deterministic=False,
                                       dropout_rng=jax.random.PRNGKey(0))[0])(t)
        return jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(g)))

    return float(norm(train, {k: jnp.asarray(v) for k, v in batch.items()}))


# ---------------------------------------------------------------------------
# the worlds of ranks, spawned once each
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return {"stonkgs": _jax_params(CFG), "prot": _jax_params(PROT_CFG, seed=2)}


@pytest.fixture(scope="module")
def data():
    return {"steps": [stonkgs_rows(CFG, 8, seed=s) for s in (11, 12)],
            "prot": [prot_rows(4, seed=s) for s in (21, 22)],
            "prot_pretrain": prot_rows(8, seed=23),
            "pretrain": stonkgs_rows(CFG, 16, seed=13)}


def _tp_operands(n_model):
    rng = np.random.default_rng(30 + n_model)
    table = rng.standard_normal((CFG.kg_table_size, 32)).astype(np.float32)
    ids = rng.integers(0, CFG.kg_table_size, (3, 7))
    vocab = CFG.bert.vocab_size if n_model == 2 else CFG.kg_vocab_size
    kernel = (0.2 * rng.standard_normal((32, vocab))).astype(np.float32)
    hidden = rng.standard_normal((4, 5, 32)).astype(np.float32)
    labels = rng.integers(0, vocab, (4, 5))
    labels[rng.random((4, 5)) < 0.3] = -100
    return table, ids, kernel, hidden, labels, vocab


@pytest.fixture(scope="module")
def world2(weights, data, tmp_path_factory):
    root = tmp_path_factory.mktemp("world2")
    feats = stonkgs_rows(CFG, 16, seed=14)
    store = str(root / "store")
    tmem.MemmapFeatureStore.write(store, feats)
    emb = root / "emb.tsv"
    vecs = np.random.default_rng(5).normal(size=(CFG.kg_vocab_size, 32)).astype(np.float32)
    emb.write_text("".join(f"node{i}\t" + "\t".join(repr(float(x)) for x in v) + "\n"
                           for i, v in enumerate(vecs)))
    ccfg = CFG.replace(num_labels=2)
    head = jax.tree.map(np.asarray, jheads.init_classifier_head(jax.random.PRNGKey(4), BERT, 2))
    cdata = _classifier_rows(16)
    cases = [
        ("tp_ops", "tp_ops", (2, *_tp_operands(2))),
        ("step_1x2", "sharded_steps", ("stonkgs", dataclasses.asdict(CFG), weights["stonkgs"],
                                       data["steps"], 1, 2)),
        ("prot_1x2", "sharded_steps", ("prot", dataclasses.asdict(PROT_CFG), weights["prot"],
                                       data["prot"], 1, 2)),
        ("prot_dropout", "prot_dropout_pretrain", (dataclasses.asdict(PROT_CFG), weights["prot"],
                                                   data["prot_pretrain"], (1, 2))),
        ("dropout", "dropout_replicas", (dataclasses.asdict(CFG), weights["stonkgs"],
                                         data["pretrain"])),
        ("multihost", "multihost_cases", ()),
        ("classifier", "train_classifier", (dataclasses.asdict(ccfg), weights["stonkgs"],
                                            head, cdata)),
        ("run_pretraining", "run_pretraining_2", (store, str(emb), str(root / "run2"))),
    ]
    out = multihost.launch(ranks.world, 2, (cases,), backend="gloo", threads=1)
    return {"ranks": out, "root": root, "store": store, "emb": str(emb), "head": head,
            "cdata": cdata, "ccfg": ccfg}


@pytest.fixture(scope="module")
def world4(weights, data, tmp_path_factory):
    root = tmp_path_factory.mktemp("world4")
    cfg_d = dataclasses.asdict(CFG)
    cases = [
        ("step_2x2", "sharded_steps", ("stonkgs", cfg_d, weights["stonkgs"], data["steps"], 2, 2)),
        ("fsdp_4x1", "sharded_steps", ("stonkgs", cfg_d, weights["stonkgs"], data["steps"], 4, 1,
                                       True)),
        ("accum_2x2", "sharded_steps", ("stonkgs", cfg_d, weights["stonkgs"], data["steps"], 2, 2,
                                        False, 2)),
        ("resume", "resume", (cfg_d, weights["stonkgs"], data["pretrain"], str(root))),
    ]
    return {"ranks": multihost.launch(ranks.world, 4, (cases,), backend="gloo", threads=1),
            "root": root}


@pytest.fixture(scope="module")
def world3():
    cases = [("tp_ops", "tp_ops", (3, *_tp_operands(3)))]
    return multihost.launch(ranks.world, 3, (cases,), backend="gloo", threads=1)


def _classifier_rows(n):
    feats = stonkgs_rows(CFG, n, seed=15)
    return {"input_ids": feats["input_ids"], "attention_mask": feats["attention_mask"],
            "token_type_ids": feats["token_type_ids"],
            "labels": np.random.default_rng(16).integers(0, 2, n)}


# ---------------------------------------------------------------------------
# spec selection (one process)
# ---------------------------------------------------------------------------

MODELS = {"stonkgs": CFG, "transe": TRANSE_CFG, "prot": PROT_CFG}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("model", sorted(MODELS))
def test_specs_and_padding_match_jax(model, mesh_shape):
    cfg = MODELS[model]
    jp = _jax_params(cfg)
    tparams = _to_port(cfg, jp)
    jm = jmesh.make_mesh(*mesh_shape)
    tm = tmesh.Mesh(*mesh_shape)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    n_split = 0
    for fsdp in (False, True):
        for min_size in (None, 512, 64):
            _, jspecs = jmesh._tree_paths_and_specs(jp, jm, fsdp, min_size)
            jspec = {p: tuple(s) for p, s in zip(jpaths, jspecs)}
            tspec = tmesh.param_specs(tparams, tm, fsdp, min_size)
            for path, spec in tspec.items():
                m = _LAYER.match(path)
                want = jspec[f"{m[1]}/{m[3]}" if m else path]
                if m:
                    assert not want or want[0] is None, (path, want)   # never the layer axis
                    want = want[1:]
                assert spec == tuple(want), (fsdp, min_size, path, spec, want)
                n_split += "data" in spec
    assert n_split > 0 or mesh_shape[0] == 1
    jpad = jax.tree.map(np.asarray, jmesh.pad_params_for_mesh(jax.tree.map(jnp.asarray, jp), jm))
    tpad = tree_flatten_with_path(tmesh.pad_params_for_mesh(tparams, tm))
    want = {k: v.numpy() for k, v in tree_flatten_with_path(_to_port(cfg, jpad)).items()}
    assert tpad.keys() == want.keys()
    for k, v in tpad.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_shard_batch_keeps_micro_batches():
    """Each data rank's micro-batch i is its share of the global
    micro-batch i; ranks of one data index get the same rows."""
    rows = np.arange(24)
    for d in range(3):
        m = tmesh.Mesh(3, 1)
        m.data_index = d
        got = tmesh.shard_batch({"x": rows}, m, micro_batches=2)["x"]
        assert got.tolist() == [4 * d + i for i in range(4)] + [12 + 4 * d + i for i in range(4)]
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch({"x": np.arange(10)}, tmesh.Mesh(4, 1))


# ---------------------------------------------------------------------------
# the vocab-parallel ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 3])
def test_tp_ops_match_jax(n_model, world2, world3):
    results = [r["tp_ops"] for r in (world2["ranks"] if n_model == 2 else world3)]
    table, ids, kernel, hidden, labels, vocab = _tp_operands(n_model)
    jm = jmesh.make_mesh(1, n_model)
    jtable = jnp.asarray(np.pad(table, ((0, (-len(table)) % n_model), (0, 0))))
    want_gather = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    jax_gather = np.asarray(jtp.tp_gather(jtable, jnp.asarray(ids), jm))
    np.testing.assert_array_equal(jax_gather, want_gather)
    pad = (-vocab) % n_model
    jkernel = jnp.asarray(np.pad(kernel, ((0, 0), (0, pad))))

    def tp_loss(w, h):
        return jtp.tp_masked_cross_entropy(w, h, jnp.asarray(labels), vocab, jm)

    def dense_loss(w, h):
        return jax_masked_ce(jnp.einsum("bkh,hv->bkv", h, w[:, :vocab]), jnp.asarray(labels))

    for fn in (tp_loss, dense_loss):
        loss, (dw, dh) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
            jkernel, jnp.asarray(hidden))
        for r in results:
            np.testing.assert_array_equal(r["gather"], want_gather)
            np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
            np.testing.assert_allclose(r["dh"], np.asarray(dh), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(r["dw"], np.asarray(dw)[:, :vocab], rtol=1e-5, atol=1e-7)
    for r in results[1:]:   # the replicated outputs are equal on every rank
        np.testing.assert_array_equal(r["dh"], results[0]["dh"])


# ---------------------------------------------------------------------------
# sharded train steps against JAX's single-device step
# ---------------------------------------------------------------------------

STEP_CASES = {"step_1x2": ("world2", "stonkgs", 1), "prot_1x2": ("world2", "prot", 1),
              "step_2x2": ("world4", "stonkgs", 1), "fsdp_4x1": ("world4", "stonkgs", 1),
              "accum_2x2": ("world4", "stonkgs", 2)}


@pytest.fixture(scope="module")
def jax_steps(weights, data):
    out = {}
    for accum in (1, 2):
        out["stonkgs", accum] = _jax_steps(CFG, weights["stonkgs"], data["steps"], accum)
    out["prot", 1] = _jax_steps(PROT_CFG, weights["prot"], data["prot"])
    out["norms"] = {"stonkgs": _jax_grad_norm(CFG, weights["stonkgs"], data["steps"][0]),
                    "prot": _jax_grad_norm(PROT_CFG, weights["prot"], data["prot"][0])}
    return out


@pytest.fixture(scope="module")
def port_steps(weights, data):
    """The port's unmeshed steps, whose clip norms and moments the sharded
    steps must reproduce (AdamW's update is blind to a gradient scaled by
    a constant; the norm and the second moment are not)."""
    cfg_d = {"stonkgs": dataclasses.asdict(CFG), "prot": dataclasses.asdict(PROT_CFG)}
    return {(model, accum): ranks.sharded_steps(model, cfg_d[model], weights[model],
                                                data["steps" if model == "stonkgs" else "prot"],
                                                accum=accum)
            for model, accum in (("stonkgs", 1), ("stonkgs", 2), ("prot", 1))}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_steps_match_jax_single_device(case, request, jax_steps, port_steps):
    world, model, accum = STEP_CASES[case]
    results = [r[case] for r in request.getfixturevalue(world)["ranks"]]
    want_metrics, want_params = jax_steps[model, accum]
    single = port_steps[model, accum]
    assert jax_steps["norms"][model] > ranks.CLIP   # the clip acts
    if accum == 1:
        np.testing.assert_allclose(single["norms"][0], jax_steps["norms"][model], rtol=1e-5)
    for r in results:
        for got, want in zip(r["metrics"], want_metrics):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{case} {k}")
        np.testing.assert_allclose(r["norms"], single["norms"], rtol=1e-5)
        assert r["params"].keys() == want_params.keys()
        for k, v in want_params.items():
            np.testing.assert_allclose(r["params"][k], v, err_msg=f"{case} {k}", **PARAM_TOL)
        for part in ("mu", "nu"):   # the moments carry the gradients' scale
            scale = max(np.abs(v).max() for v in single[part].values())
            for k, v in single[part].items():
                np.testing.assert_allclose(r[part][k], v, rtol=1e-4, atol=1e-6 * scale,
                                           err_msg=f"{case} {part} {k}")
    for r in results[1:]:
        for k, v in results[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=f"{case} {k}")
    if case == "fsdp_4x1":   # params and moments stay split between steps
        shapes = results[0]["fsdp_shapes"]
        assert shapes
        for path, (shape, mu_shape) in shapes.items():
            assert shape == mu_shape and np.prod(shape) * 4 == want_params[path].size, path


# ---------------------------------------------------------------------------
# dropout, the 1x1 mesh, the resume
# ---------------------------------------------------------------------------

def test_prot_dropout_on_1x2_matches_the_unmeshed_run(world2, weights, data):
    """ProtSTonKGs ``pretrain`` on a 1x2 mesh (the KG table row-split, the
    protein head vocab-parallel) with hidden dropout 0.1, fp32, against
    the port's unmeshed ``pretrain`` with the same seed: a 1 x n mesh draws
    the unmeshed run's dropout masks, so it must match it as closely as
    the dropout-free steps match JAX."""
    want = ranks.prot_dropout_pretrain(dataclasses.asdict(PROT_CFG), weights["prot"],
                                       data["prot_pretrain"])
    assert len(want["losses"]) == 2 and all(np.isfinite(want["losses"]))
    for r in (r["prot_dropout"] for r in world2["ranks"]):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        assert r["params"].keys() == want["params"].keys()
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["params"][k], v, err_msg=k, **PARAM_TOL)


def test_dropout_keeps_replicas_bit_equal(world2):
    a, b = (r["dropout"] for r in world2["ranks"])
    for part in ("params", "mu", "nu"):
        assert a[part].keys() == b[part].keys() and a[part]
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")


def _dropout_cfg():
    cfg = _port(CFG)
    return cfg.replace(bert=dataclasses.replace(cfg.bert, hidden_dropout_prob=0.1,
                                                attention_probs_dropout_prob=0.1))


def test_one_by_one_mesh_is_the_unmeshed_run(weights, data, tmp_path):
    """``pretrain(mesh=make_mesh(1, 1))`` with dropout on, in a gloo world of
    one and without a process group, equals the unmeshed run bit for bit."""
    cfg = _dropout_cfg()
    run = tpre.PretrainingConfig(learning_rate=ranks.LR, max_steps=2, micro_batch_size=4,
                                 grad_accumulation_steps=2, log_steps=1, compute_dtype="float32",
                                 seed=9)

    def go(mesh):
        logged = []
        state = tpre.pretrain(cfg, params_from_jax(weights["stonkgs"], cfg), data["pretrain"],
                              run, mesh=mesh, log_fn=lambda s, m: logged.append(m["loss"]))
        return logged, tree_flatten_with_path(state.params)

    want_losses, want = go(None)
    got_losses, got = go(tmesh.make_mesh(1, 1))   # no process group
    assert got_losses == want_losses and all(torch.equal(got[k], want[k]) for k in want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0)
    try:
        mesh = tmesh.make_mesh(1, 1)
        assert mesh.device_mesh is not None
        got_losses, got = go(mesh)
    finally:
        dist.destroy_process_group()
    assert got_losses == want_losses
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_resume_on_the_mesh_replays_the_run(world4, weights):
    results = [r["resume"] for r in world4["ranks"]]
    for r in results:
        whole, resumed = r["whole"], r["resumed"]
        assert [s for s, _ in whole["losses"]] == [1, 2, 3, 4]
        assert [s for s, _ in resumed["losses"]] == [1, 2, 3, 4]
        assert whole["losses"] == resumed["losses"]
        assert whole["step"] == resumed["step"] == 4
        for part in ("params", "mu"):
            for k, v in whole[part].items():
                np.testing.assert_array_equal(resumed[part][k], v, err_msg=f"{part} {k}")
        assert r["checkpoints"] == [2, 4]
    # the gathered checkpoint holds unpadded leaves and loads in one process
    cfg = _dropout_cfg()
    params = params_from_jax(weights["stonkgs"], cfg)
    template = tpre.init_train_state(params, AdamW())
    state = tckpt.CheckpointManager(str(world4["root"] / "resumed")).restore_latest(template)
    assert state.step == 4 and state.layout is None
    for k, v in tree_flatten_with_path(state.params).items():
        np.testing.assert_array_equal(v.numpy(), results[0]["resumed"]["params"][k], err_msg=k)
    for k, v in tree_flatten_with_path(state.opt_state["mu"]).items():
        np.testing.assert_array_equal(v.numpy(), results[0]["resumed"]["mu"][k], err_msg=k)


# ---------------------------------------------------------------------------
# multihost, fine-tuning, run_pretraining, the dry run
# ---------------------------------------------------------------------------

def test_multihost_on_gloo_ranks(world2):
    results = [r["multihost"] for r in world2["ranks"]]
    assert [r["slice"] for r in results] == [slice(0, 8), slice(8, 16)]
    for r in results:
        assert r["backend"] == "gloo"
        np.testing.assert_array_equal(r["whole"], np.arange(64).reshape(16, 4))
    seen = results[0]["seen"] + results[1]["seen"]
    assert sorted(seen) == list(range(32))   # one epoch over both ranks, no dup or drop
    multihost.initialize()   # one process: no process group
    assert not dist.is_initialized()
    assert multihost.host_local_slice(16) == slice(0, 16)


def test_train_classifier_on_2x1_matches_jax(world2, weights):
    ccfg, feats, head = world2["ccfg"], world2["cdata"], world2["head"]
    params = {**weights["stonkgs"]}
    run = jft.FinetuneConfig(epochs=1, lr=ranks.LR, batch_size=4, compute_dtype="float32")
    jstate, jmetrics = jft.train_classifier(ccfg, jax.tree.map(jnp.asarray, params), feats, run,
                                            mesh=jmesh.make_mesh(2, 1), rng_seed=3)
    np.testing.assert_array_equal(np.asarray(jstate.params["classifier"]["kernel"]).shape,
                                  head["kernel"].shape)
    want = {k: v.numpy() for k, v in tree_flatten_with_path(split_frozen(
        _to_port(ccfg, jax.tree.map(np.asarray, jstate.params)))[0]).items()}
    for r in (r["classifier"] for r in world2["ranks"]):
        assert r["step"] == 4
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(r["metrics"][k], float(jmetrics[k]), rtol=1e-5, err_msg=k)
        assert r["params"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, err_msg=k, **PARAM_TOL)


def test_run_pretraining_on_two_ranks(world2, tmp_path):
    """``run_pretraining(n_model_shards=2)`` on a 1x2 mesh, 3 steps then a
    resume to 5, against one process: the main rank alone logs and saves."""
    got = [r["run_pretraining"] for r in world2["ranks"]]
    kw = dict(kg_embedding_path=world2["emb"], batch_size=4, save_steps=2, log_steps=1,
              output_dir=str(tmp_path / "run1"), compute_dtype="float32", device="cpu")
    tcli.run_pretraining(world2["store"], max_steps=3, **kw)
    want = tree_flatten_with_path(tcli.run_pretraining(world2["store"], max_steps=5, **kw).params)
    for r in got:
        assert r["steps"] == (3, 5) and r["mesh"] == (1, 2)
        assert r["params"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v.numpy(), err_msg=k, **PARAM_TOL)
    out = world2["root"] / "run2"
    assert sorted(os.listdir(out / "checkpoints")) == ["2", "3", "4", "5"]
    logs = [n for n in sorted(os.listdir(out)) if n.endswith(".jsonl")]
    steps = [rec["step"] for n in logs for rec in map(json.loads, open(out / n))
             if rec.get("key") == "loss"]
    assert steps == [1, 2, 3, 4, 5]


def test_dryrun_multichip_four_ranks(capsys):
    result = dryrun.dryrun_multichip(4)
    assert result["mesh"] == (2, 2) and result["pooled"] == (2, 64)
    assert len(result["losses"]) == 4 and len(result["fsdp_losses"]) == 2
    assert len(result["prot_losses"]) == 2 and len(result["transe_losses"]) == 2
    assert "dryrun_multichip(4): mesh 2x2" in capsys.readouterr().out


def test_an_axis_of_one_rank_splits_nothing():
    """On a 1 x 1 or 2 x 1 mesh the decoders are whole: their gradients
    go with the replicated ones and the clip takes the unmeshed norm."""
    tparams = _to_port(CFG, _jax_params(CFG))
    for shape in ((1, 1), (2, 1)):
        m = tmesh.Mesh(*shape)
        layout = tmesh.ParamLayout(m, tmesh.param_specs(tparams, m), {})
        assert layout.kind("cls/predictions/text_decoder/kernel") == "replicated"
        assert layout.kind("kg_backbone") == "replicated"
        assert layout.grad_norm(list(tree_flatten_with_path(split_frozen(tparams)[0]))) is None
    m = tmesh.Mesh(1, 2)
    layout = tmesh.ParamLayout(m, tmesh.param_specs(tparams, m), {})
    assert layout.kind("cls/predictions/text_decoder/kernel") == "model"
    assert layout.grad_norm(["cls/predictions/text_decoder/kernel"]) is not None
