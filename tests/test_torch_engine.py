"""The port's ``STonKGsEngine`` against the JAX package's engine, on the CPU.

Both engines get the same JAX-initialised weights (through
``params_from_jax`` for the port) and the same features; the port runs
with ``device="cpu"``, where its kernels take their plain versions.
Tolerance: atol 1e-4 and rtol 1e-4 at fp32, as the model tests.
"""

import numpy as np
import pytest
import torch

from stonkgs_tpu.api.inference import STonKGsEngine as JaxEngine
from stonkgs_tpu_torch import STonKGsEngine
from stonkgs_tpu_torch.utils.convert import params_from_jax

from test_torch_models import CFG, features, jax_params, port_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
LENGTHS = [16, 3, 9, 1, 12, 4, 7]   # 7 rows: batches of 3 leave a ragged last batch


@pytest.fixture(scope="module")
def params():
    return jax_params(CFG)


def _engines(params, **kw):
    jax_eng = JaxEngine(cfg=CFG, params=params, compute_dtype="float32", **kw)
    port = STonKGsEngine(cfg=port_cfg(CFG), params=params_from_jax(params, port_cfg(CFG)),
                         compute_dtype="float32", device="cpu", **kw)
    return jax_eng, port


def test_embed_logits_proba_match_jax_engine(params):
    jax_eng, port = _engines(params, batch_size=3)
    feats = features(CFG, LENGTHS, seed=7)
    got = port.embed(feats)
    assert got.shape == (len(LENGTHS), CFG.bert.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_eng.embed(feats), **TOL)
    np.testing.assert_allclose(port.logits(feats), jax_eng.logits(feats), **TOL)
    proba = port.predict_proba(feats)
    np.testing.assert_allclose(proba, jax_eng.predict_proba(feats), **TOL)
    np.testing.assert_allclose(proba.sum(-1), 1.0, rtol=1e-6)


def test_length_buckets_match_jax_engine(params):
    jax_eng, port = _engines(params, batch_size=3, length_buckets=(4, 8))
    assert port.length_buckets == (4, 8)
    feats = features(CFG, LENGTHS, seed=8)
    groups = {b: sorted(idx.tolist()) for b, idx, _, _ in port._bucket_features(feats)}
    assert groups == {4: [1, 3, 5], 8: [6], 16: [0, 2, 4]}
    np.testing.assert_allclose(port.embed(feats), jax_eng.embed(feats), **TOL)
    np.testing.assert_allclose(port.logits(feats), jax_eng.logits(feats), **TOL)
    # latency-shaped request (one batch): one dispatch at the smallest
    # bucket that fits its longest row
    small = features(CFG, [2, 6, 3], seed=9)
    assert [b for b, *_ in port._bucket_features(small)] == [8]
    np.testing.assert_allclose(port.embed(small), jax_eng.embed(small), **TOL)


def test_empty_input_and_bad_buckets(params):
    _, port = _engines(params, batch_size=3)
    empty = {k: v[:0] for k, v in features(CFG, [1], seed=0).items()}
    assert port.embed(empty).shape == (0, CFG.bert.hidden_size)
    assert port.logits(empty).shape == (0, CFG.num_labels)
    with pytest.raises(ValueError):
        STonKGsEngine(cfg=port_cfg(CFG), params=port.params, device="cpu",
                      length_buckets=(CFG.text_len + 1,))


def test_default_device_needs_cuda(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        STonKGsEngine(cfg=port_cfg(CFG), params=params_from_jax(params, port_cfg(CFG)))
