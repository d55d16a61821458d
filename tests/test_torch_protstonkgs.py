"""The port's ProtSTonKGs against the JAX package at fp32, on the CPU.

A small configuration in the shape of ``tests/test_prot_training.py``
(trunk of block size 4 with one random block at S=32, which takes the
block-sparse path; text chunks of 4, a 16-token protein part), with every
dropout at 0 so that training mode is comparable.  Weights come from the
JAX ``init_protstonkgs_params`` through ``protstonkgs_params_from_jax``;
batches are made with a numpy seed.

The pre-training loss and its gradients are also held at the trunk's
block size 128 (``CFG128``: S=1024 laid out text 384 | KG 128 | protein
512, the text in 3 chunks of 128), where the trunk's middle blocks take
the kernels' block-128 plain versions.

Tolerances: pooled outputs and logits within 1e-5 absolute; losses within
1e-5 absolute; gradients within 2e-5 absolute + 1e-4 relative; parameters
after one AdamW step within 1e-5 absolute, 1% of the step (both frameworks
sum in fp32, in another order, through every layer).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stonkgs_tpu import config as jconfig
from stonkgs_tpu.models import protstonkgs as jprot
from stonkgs_tpu.train import pretraining as jpre
from stonkgs_tpu.train.optimizer import make_optimizer
from stonkgs_tpu_torch import ProtSTonKGsEngine
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.train import optimizer as topt
from stonkgs_tpu_torch.train import pretraining as tpre
from stonkgs_tpu_torch.utils.convert import bigbird_params_from_jax, protstonkgs_params_from_jax
from stonkgs_tpu_torch.utils.tree import tree_leaves, tree_map

FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _bert(**kw):
    return jconfig.BertConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                              num_hidden_layers=1, num_attention_heads=2, **kw)


CFG = jconfig.ProtSTonKGsConfig(
    trunk=jconfig.BigBirdConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, block_size=4, num_random_blocks=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
    lm=_bert(vocab_size=128, hidden_size=32, intermediate_size=64, max_position_embeddings=8),
    prot=_bert(vocab_size=30, hidden_size=16, intermediate_size=32, max_position_embeddings=16),
    kg_vocab_size=150, kg_start_idx=12, prot_start_idx=16, seq_len=32,
    sep_id=102, mask_id=103, unk_id=100, num_labels=3)


CFG128 = jconfig.ProtSTonKGsConfig(
    trunk=dataclasses.replace(CFG.trunk, hidden_size=16, intermediate_size=32,
                              max_position_embeddings=1024, block_size=128),
    lm=_bert(vocab_size=128, hidden_size=16, intermediate_size=32, max_position_embeddings=128),
    prot=_bert(vocab_size=30, hidden_size=8, intermediate_size=16, max_position_embeddings=512),
    kg_vocab_size=150, kg_start_idx=384, prot_start_idx=512, seq_len=1024,
    sep_id=102, mask_id=103, unk_id=100, num_labels=3)


def port_cfg(cfg):
    """The port's config with the same fields as a JAX-package config."""
    d = dataclasses.asdict(cfg)
    return tconfig.ProtSTonKGsConfig(**{
        **d, "trunk": tconfig.BigBirdConfig(**d["trunk"]),
        "lm": tconfig.BertConfig(**d["lm"]), "prot": tconfig.BertConfig(**d["prot"])})


TCFG = port_cfg(CFG)


def features(n, seed=0, padded=True, cfg=CFG):
    """Rows of random ids with k = max(int(0.15 * len), 1) masked positions
    per segment; with ``padded`` the trunk masks the tail of some rows (the
    last 7/32 of the sequence: inside a middle block)."""
    rng = np.random.default_rng(seed)
    tl, el, pl = cfg.text_len, cfg.entity_len, cfg.prot_len
    ids = np.concatenate([rng.integers(0, cfg.lm_vocab_size, (n, tl)),
                          rng.integers(0, cfg.kg_table_size, (n, el)),
                          rng.integers(0, cfg.prot_vocab_size, (n, pl))], 1)
    mask = np.ones((n, cfg.seq_len), np.int64)
    if padded:
        mask[::2, cfg.seq_len * 25 // 32:] = 0
    out = {"input_ids": ids.astype(np.int64), "attention_mask": mask}
    for name, a, b, vocab in (("masked_lm_labels", 0, tl, cfg.lm_vocab_size),
                              ("ent_masked_lm_labels", tl, tl + el, cfg.kg_vocab_size),
                              ("prot_masked_lm_labels", tl + el, cfg.seq_len,
                               cfg.prot_vocab_size)):
        k = max(int((b - a) * 0.15), 1)
        lab = np.full((n, b - a), -100, np.int64)
        for i in range(n):
            lab[i, rng.choice(b - a, k, replace=False)] = rng.integers(0, vocab, k)
        out[name] = lab
    return out


def _jax_params(cfg):
    p = jax.jit(lambda key: jprot.init_protstonkgs_params(key, cfg, with_classifier=True))(
        jax.random.PRNGKey(0))
    p["kg_backbone"] = jax.random.normal(jax.random.PRNGKey(1),
                                         (cfg.kg_table_size, cfg.trunk.hidden_size))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def params():
    return _jax_params(CFG)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return tpre.to_device(batch, "cpu")


TRAIN_KEYS = ("trunk", "prot_projection", "cls")


def _port_trainable(tree, tcfg=TCFG):
    """A JAX trainable tree (numpy leaves) in the port's layout."""
    out = {"trunk": bigbird_params_from_jax(tree["trunk"], tcfg.trunk)}
    for k in ("prot_projection", "cls"):
        out[k] = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree[k])
    return out


@pytest.mark.parametrize("trunk_type", [None, "original_full"], ids=["sparse", "full"])
def test_trunk_forward_pooled_matches_jax(params, trunk_type):
    batch = features(3, seed=1)
    want_seq, want = jprot.trunk_forward(
        jax.tree.map(jnp.asarray, params), CFG, jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["attention_mask"]), trunk_attention_type=trunk_type,
        trunk_attention_impl="xla")
    tb = _tb(batch)
    got_seq, got = tprot.trunk_forward(protstonkgs_params_from_jax(params, TCFG), TCFG,
                                       tb["input_ids"], tb["attention_mask"],
                                       trunk_attention_type=trunk_type)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("dense_heads,block", [(False, 4), (True, 4), (False, 128)],
                         ids=["gathered", "dense", "gathered-bs128"])
def test_pretraining_loss_and_grads_match_jax(params, dense_heads, block):
    """The loss and the trunk, projection and head gradients in training
    mode (the training plan); at block 128 the trunk's block-sparse layers
    run the kernels' block-128 plain versions."""
    cfg, tcfg = (CFG, TCFG) if block == CFG.trunk.block_size else (CFG128, port_cfg(CFG128))
    if cfg is CFG128:
        params = _jax_params(CFG128)
        from stonkgs_tpu_torch.models.bigbird import effective_attention_type
        assert effective_attention_type(tcfg.trunk, tcfg.seq_len) == "block_sparse"
    batch = features(3, seed=2, cfg=cfg)
    jp = jax.tree.map(jnp.asarray, params)
    frozen = {k: jp[k] for k in ("lm_backbone", "prot_backbone", "kg_backbone", "classifier")}

    def jloss(train):
        return jprot.pretraining_loss({**train, **frozen}, cfg, _jb(batch),
                                      dense_heads=dense_heads, deterministic=False,
                                      dropout_rng=jax.random.PRNGKey(0))

    value_and_grad = jax.value_and_grad(jloss, has_aux=True)
    if cfg is CFG128:   # op by op, the sparse gathers at S=1024 take ~25 s on the CPU
        value_and_grad = jax.jit(value_and_grad)
    (jl, jm), jg = value_and_grad({k: jp[k] for k in TRAIN_KEYS})
    tp = protstonkgs_params_from_jax(params, tcfg)
    leaves = tree_leaves({k: tp[k] for k in TRAIN_KEYS})
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = tprot.pretraining_loss(tp, tcfg, _tb(batch), dense_heads=dense_heads,
                                    deterministic=False, rng=tpre.step_rng(0, 0, "cpu"))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    for k in ("loss", "text_loss", "entity_loss", "prot_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **FWD_TOL)
    got = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    want = tree_leaves(_port_trainable(jax.tree.map(np.asarray, jg), tcfg))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"grad leaf {i}", **GRAD_TOL)


def test_pretraining_logits_match_jax(params):
    batch = features(2, seed=3)
    want = jprot.pretraining_logits(jax.tree.map(jnp.asarray, params), CFG,
                                    jnp.asarray(batch["input_ids"]),
                                    jnp.asarray(batch["attention_mask"]))
    tb = _tb(batch)
    got = tprot.pretraining_logits(protstonkgs_params_from_jax(params, TCFG), TCFG,
                                   tb["input_ids"], tb["attention_mask"])
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_classification_logits_match_jax(params):
    batch = features(3, seed=4)
    want = jprot.classification_logits(jax.tree.map(jnp.asarray, params), CFG, _jb(batch))
    got = tprot.classification_logits(protstonkgs_params_from_jax(params, TCFG), TCFG,
                                      _tb(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    # the training half (the whole trunk, the training plan) at dropout 0
    want = jprot.classification_logits(jax.tree.map(jnp.asarray, params), CFG, _jb(batch),
                                       deterministic=False,
                                       dropout_rng=jax.random.PRNGKey(0))
    got = tprot.classification_logits(protstonkgs_params_from_jax(params, TCFG), TCFG,
                                      _tb(batch), deterministic=False,
                                      rng=tpre.step_rng(0, 0, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_build_kg_table_matches_jax(params):
    vecs = np.random.default_rng(5).normal(size=(CFG.kg_vocab_size, 32)).astype(np.float32)
    want = np.asarray(jprot.build_kg_table(jax.tree.map(jnp.asarray, params["lm_backbone"]),
                                           CFG, vecs))
    tp = protstonkgs_params_from_jax(params, TCFG)
    got = tprot.build_kg_table(tp["lm_backbone"], TCFG, vecs).numpy()
    assert got.shape == (CFG.kg_table_size, 32)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    # the BigBird tokenizer's ids by default, not BERT's
    assert (tconfig.ProtSTonKGsConfig().sep_id, tconfig.ProtSTonKGsConfig().mask_id) == (66, 67)


def test_config_matches_jax():
    for jc, tc in ((jconfig.ProtSTonKGsConfig(trunk=jconfig.BigBirdConfig(), kg_vocab_size=7),
                    tconfig.ProtSTonKGsConfig(trunk=tconfig.BigBirdConfig(), kg_vocab_size=7)),
                   (CFG, TCFG)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert (jc.text_len, jc.entity_len, jc.prot_len, jc.kg_table_size) == (
            tc.text_len, tc.entity_len, tc.prot_len, tc.kg_table_size)


def test_engine_embed_and_logits_on_cpu(params):
    batch = features(5, seed=6)
    jp = jax.tree.map(jnp.asarray, params)
    _, want = jprot.trunk_forward(jp, CFG, jnp.asarray(batch["input_ids"]),
                                  jnp.asarray(batch["attention_mask"]), cls_only=True)
    engine = ProtSTonKGsEngine(cfg=TCFG, params=protstonkgs_params_from_jax(params, TCFG),
                               device="cpu", compute_dtype="float32", batch_size=2)
    got = engine.embed(batch)
    assert got.shape == (5, CFG.trunk.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    want_lg = jprot.classification_logits(jp, CFG, _jb(batch))
    np.testing.assert_allclose(engine.logits(batch), np.asarray(want_lg), **FWD_TOL)


def test_engine_defaults_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtSTonKGsEngine(cfg=TCFG, params=protstonkgs_params_from_jax(params, TCFG))


def test_train_step_matches_jax(params):
    """One step of make_train_step(loss_fn=protstonkgs.pretraining_loss):
    metrics and updated trainable parameters as the JAX step's, frozen
    backbones unchanged, the projection trained."""
    batch = features(4, seed=7)
    tx = make_optimizer(None, learning_rate=1e-3, total_steps=10)
    jstate = jpre.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jpre.make_train_step(CFG, tx, loss_fn=jprot.pretraining_loss,
                                 compute_dtype=jnp.float32, donate=False)
    jstate, jm = jstep(jstate, _jb(batch))

    tp = protstonkgs_params_from_jax(params, TCFG)
    before = tree_map(lambda t: t.clone(), tp)
    ttx = topt.AdamW(learning_rate=1e-3, total_steps=10)
    tstate = tpre.init_train_state(tp, ttx)
    tstep = tpre.make_train_step(TCFG, ttx, loss_fn=tprot.pretraining_loss,
                                 compute_dtype=torch.float32)
    tstate, tm = tstep(tstate, _tb(batch))
    for k in ("loss", "text_loss", "entity_loss", "prot_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **FWD_TOL)
    want = _port_trainable(jax.tree.map(np.asarray, jstate.params))
    for k in TRAIN_KEYS:
        for i, (g, w) in enumerate(zip(tree_leaves(tstate.params[k]), tree_leaves(want[k]))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{k} leaf {i}")
    for k in ("lm_backbone", "prot_backbone", "kg_backbone"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tstate.params[k]),
                                                     tree_leaves(before[k])))
    assert not torch.equal(tstate.params["prot_projection"]["kernel"],
                           before["prot_projection"]["kernel"])


def test_pretrain_runs_with_protstonkgs_loss(params):
    """pretrain(loss_fn=protstonkgs.pretraining_loss) with the dropouts on
    and a precomputed training plan: finite losses, the three segment
    losses logged, frozen backbones untouched."""
    import functools

    from stonkgs_tpu_torch.ops.bigbird_sparse import build_rand_attn

    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    cfg = TCFG.replace(trunk=dataclasses.replace(TCFG.trunk, **drop),
                       lm=dataclasses.replace(TCFG.lm, **drop),
                       prot=dataclasses.replace(TCFG.prot, **drop))
    tp = protstonkgs_params_from_jax(params, cfg)
    before = tree_map(lambda t: t.clone(), tp)
    t = cfg.trunk
    plan = build_rand_attn(cfg.seq_len, t.block_size, t.num_random_blocks,
                           t.num_attention_heads, t.num_hidden_layers,
                           t.max_position_embeddings, training=True)
    logged = []
    run = tpre.PretrainingConfig(max_steps=2, micro_batch_size=2, log_steps=1,
                                 compute_dtype="float32")
    state = tpre.pretrain(cfg, tp, features(6, seed=8), run,
                          log_fn=lambda step, m: logged.append((step, m)),
                          loss_fn=functools.partial(tprot.pretraining_loss, rand_attn=plan))
    assert [s for s, _ in logged] == [1, 2]
    assert all(np.isfinite(m["loss"]) and {"text_loss", "entity_loss", "prot_loss"} <= set(m)
               for _, m in logged)
    for k in ("lm_backbone", "prot_backbone", "kg_backbone"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params[k]),
                                                     tree_leaves(before[k])))
    assert not torch.equal(state.params["trunk"]["encoder"][0]["intermediate"]["kernel"],
                           before["trunk"]["encoder"][0]["intermediate"]["kernel"])


def test_params_from_jax_layout(params):
    tp = protstonkgs_params_from_jax(params, TCFG)
    assert set(tp) == {"trunk", "lm_backbone", "prot_backbone", "prot_projection",
                       "kg_backbone", "cls", "classifier"}
    assert len(tp["trunk"]["encoder"]) == CFG.trunk.num_hidden_layers
    assert len(tp["prot_backbone"]["encoder"]) == CFG.prot.num_hidden_layers
    assert tuple(tp["prot_projection"]["kernel"].shape) == (16, 32)
    assert set(tp["cls"]["predictions"]) >= {"text_decoder", "entity_decoder", "prot_decoder",
                                             "prot_bias"}
