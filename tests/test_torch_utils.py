"""The port's utilities against the JAX package's, on the CPU.

* ``utils/parity.py::verify_parity`` on a checkpoint of
  ``tests/torch_golden.py::GoldenSTonKGs`` below 5e-4, the bound of
  ``tests/test_parity_tool.py`` (fp32 on both sides; the reduction order
  differs), its report as the JAX tool prints it, and a fault on the
  port's side rejected;
* ``utils/cache.py``: the same paths as the JAX package's under the same
  environment, a filled cache served with no network, the offline error;
* ``utils/profiling.py``, ``utils/init.py``, ``version.py`` and
  ``constants.py``.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from stonkgs_tpu import constants as jconstants
from stonkgs_tpu import version as jversion
from stonkgs_tpu.utils import cache as jcache
from stonkgs_tpu.utils import parity as jparity
from stonkgs_tpu_torch import config as tconfig
from stonkgs_tpu_torch import constants as tconstants
from stonkgs_tpu_torch import version as tversion
from stonkgs_tpu_torch.data.artifacts import KGArtifacts, save_kg_artifacts
from stonkgs_tpu_torch.models import bert as tbert
from stonkgs_tpu_torch.models import protstonkgs as tprot
from stonkgs_tpu_torch.models import stonkgs as tstonkgs
from stonkgs_tpu_torch.utils import cache as tcache
from stonkgs_tpu_torch.utils import hf_loader, profiling
from stonkgs_tpu_torch.utils import init as tinit
from stonkgs_tpu_torch.utils import parity as tparity
from stonkgs_tpu_torch.utils.tree import tree_flatten_with_path

from torch_golden import GoldenSTonKGs

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=128,
    max_position_embeddings=64, type_vocab_size=2,
)
KG_VOCAB, RW_LEN, TEXT_LEN = 120, 15, 32
PARITY_BOUND = 5e-4


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    """A golden checkpoint with a 3-class classifier and its KG TSVs."""
    root = tmp_path_factory.mktemp("parity")
    golden = GoldenSTonKGs(TINY, KG_VOCAB, TEXT_LEN, num_labels=3)
    (root / "model").mkdir()
    torch.save(golden.reference_state_dict(), root / "model" / "pytorch_model.bin")
    (root / "model" / "config.json").write_text(json.dumps({**TINY, "num_labels": 3}))
    rng = np.random.default_rng(0)
    names = [f"node{i}" for i in range(KG_VOCAB)]
    art = KGArtifacts(names=names, name_to_idx={n: i for i, n in enumerate(names)},
                      vectors=golden.kg_vectors,
                      walk_indices=rng.integers(0, KG_VOCAB, (KG_VOCAB, RW_LEN),
                                                dtype=np.int32),
                      rw_len=RW_LEN)
    save_kg_artifacts(art, root / "emb.tsv", root / "walks.tsv")
    return root


def _paths(root):
    return str(root / "model"), str(root / "emb.tsv"), str(root / "walks.tsv")


def test_verify_parity_passes_on_golden(golden_files):
    report = tparity.verify_parity(*_paths(golden_files), n_rows=4, device="cpu")
    assert report.max_dev < PARITY_BOUND, report.summary()
    assert report.max_dev_logits is not None and report.n_rows == 4
    assert report.summary(PARITY_BOUND).startswith("PASS")
    # the JAX tool on the same files sees the same agreement
    want = jparity.verify_parity(*_paths(golden_files), n_rows=4)
    assert want.max_dev < PARITY_BOUND


def _shifted_loader(monkeypatch, shift):
    """The port's loader with the NSP bias shifted: a fault on the port's
    side only (both sides read the same file)."""
    load = hf_loader.stonkgs_params_from_state_dict

    def shifted(*a, **kw):
        p = load(*a, **kw)
        p["cls"]["seq_relationship"]["bias"] += shift
        return p

    monkeypatch.setattr(hf_loader, "stonkgs_params_from_state_dict", shifted)


def test_verify_parity_rejects_a_fault(golden_files, monkeypatch):
    _shifted_loader(monkeypatch, 1e-2)
    report = tparity.verify_parity(*_paths(golden_files), n_rows=4, device="cpu")
    assert abs(report.max_dev_nsp - 1e-2) < 1e-5
    assert report.max_dev_pooled < PARITY_BOUND
    assert report.summary(1e-3).startswith("FAIL")


def test_parity_report_prints_as_the_jax_tool():
    vals = dict(max_dev_pooled=1.5e-7, max_dev_mlm=3e-6, max_dev_elm=2e-6, max_dev_nsp=4e-8,
                n_rows=8)
    for logits in (None, 2e-7):
        got = tparity.ParityReport(**vals, max_dev_logits=logits)
        want = jparity.ParityReport(**vals, max_dev_logits=logits)
        assert got.max_dev == want.max_dev
        for tol in (1e-5, 1e-6):
            assert got.summary(tol) == want.summary(tol)


def test_verify_parity_keeps_tf32_setting(golden_files):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tparity._no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


URLS = [
    ("https://zenodo.org/record/5205687/files/embeddings_best_model.tsv", ""),
    ("https://huggingface.co/dmis-lab/biobert-v1.1/raw/main/vocab.txt", "misc"),
    ("https://zenodo.org/record/5205530/files/pytorch_model.bin", "species"),
    ("https://huggingface.co/stonkgs/stonkgs-150k/resolve/main/config.json",
     "hub/stonkgs--stonkgs-150k"),
]


@pytest.mark.parametrize("url, sub", URLS)
def test_cache_paths_equal_jax(url, sub, tmp_path, monkeypatch):
    monkeypatch.setattr(jcache, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(tcache, "CACHE_DIR", tmp_path)
    assert tcache.cache_path(url, sub) == jcache.cache_path(url, sub)


def test_cache_and_constants_follow_the_environment(tmp_path):
    """Both packages read STONKGS_TPU_HOME and STONKGS_TPU_CACHE alike:
    every constant and the cache root, in a fresh process."""
    code = (
        "import json\n"
        "from stonkgs_tpu import constants as j\n"
        "from stonkgs_tpu_torch import constants as t\n"
        "from stonkgs_tpu.utils import cache as jc\n"
        "from stonkgs_tpu_torch.utils import cache as tc\n"
        "names = [n for n in dir(j) if n.isupper()]\n"
        "print(json.dumps({'names': names, 'same': [str(getattr(j, n)) == str(getattr(t, n))\n"
        "                                           for n in names],\n"
        "                  'cache': [str(jc.CACHE_DIR), str(tc.CACHE_DIR)],\n"
        "                  'home': str(t.HOME)}))\n"
        "t.ensure_dirs()\n"
    )
    for env in ({"STONKGS_TPU_HOME": str(tmp_path / "home")},
                {"STONKGS_TPU_HOME": str(tmp_path / "home2"),
                 "STONKGS_TPU_CACHE": str(tmp_path / "cache")}):
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                             env={**{k: v for k, v in os.environ.items()
                                     if not k.startswith("STONKGS_TPU_")},
                                  "PYTHONPATH": str(ROOT), **env},
                             capture_output=True, text=True, timeout=120).stdout
        got = json.loads(out.splitlines()[-1])
        assert all(got["same"]) and len(got["names"]) > 30
        assert got["cache"][0] == got["cache"][1]
        assert got["cache"][1] == env.get("STONKGS_TPU_CACHE",
                                          str(Path(env["STONKGS_TPU_HOME"]) / "cache"))
        assert (Path(got["home"]) / "models" / "kg-hpo").is_dir()


def test_constants_equal_jax():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


def test_dotenv_fills_without_overriding(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("# comment\nA_STONKGS_KEY='x'\nB_STONKGS_KEY=y\nnot a line\n")
    monkeypatch.setenv("B_STONKGS_KEY", "kept")
    monkeypatch.delenv("A_STONKGS_KEY", raising=False)
    tconstants._load_dotenv(str(tmp_path / ".env"))
    assert os.environ["A_STONKGS_KEY"] == "x" and os.environ["B_STONKGS_KEY"] == "kept"
    monkeypatch.delenv("A_STONKGS_KEY")


def _no_network(calls):
    def fail(url, *a, **kw):
        calls.append(url)
        raise OSError("no network")
    return fail


def test_ensure_serves_a_filled_cache_and_fails_offline(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network(calls))
    monkeypatch.setattr(tcache, "CACHE_DIR", tmp_path)
    url, sub = URLS[2]
    path = tcache.cache_path(url, sub)
    with pytest.raises(RuntimeError, match=str(path)) as err:
        tcache.ensure(url, sub)
    assert "offline" in str(err.value) and calls == [url]
    assert not path.exists() and not path.with_suffix(".bin.part").exists()
    path.write_bytes(b"weights")
    assert tcache.ensure(url, sub) == path and calls == [url]   # no second fetch
    # the JAX package raises the same error for the same missing file
    monkeypatch.setattr(jcache, "CACHE_DIR", tmp_path)
    with pytest.raises(RuntimeError) as jerr:
        jcache.ensure(URLS[0][0])
    with pytest.raises(RuntimeError) as terr:
        tcache.ensure(URLS[0][0])
    assert str(terr.value) == str(jerr.value)


def test_ensure_downloads_only_a_missing_file(tmp_path, monkeypatch):
    fetched = []

    def fetch(url, dest):
        fetched.append(url)
        Path(dest).write_text("downloaded")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    monkeypatch.setattr(tcache, "CACHE_DIR", tmp_path)
    url, sub = URLS[1]
    path = tcache.ensure(url, sub)
    assert path == tmp_path / "misc" / "vocab.txt" and path.read_text() == "downloaded"
    assert tcache.ensure(url, sub) == path and fetched == [url]
    tcache.ensure(url, sub, force=True)
    assert fetched == [url, url]


def test_step_timer_statistics():
    timer = profiling.StepTimer(window=3)
    assert timer.mean == 0.0 and timer.p50 == 0.0 and timer.throughput(8) == 0.0
    for _ in range(5):
        timer.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        dt = timer.stop(x)                    # a tensor to fetch
        assert dt > 0
    timer.start()
    timer.stop(np.ones(3))                    # anything numpy takes
    assert len(timer._times) == 3
    assert timer.mean == pytest.approx(float(np.mean(timer._times)))
    assert timer.p50 == pytest.approx(float(np.median(timer._times)))
    assert timer.throughput(10) == pytest.approx(10 / timer.mean)


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.annotate("matmul span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "matmul span" for e in events)
    assert any("mm" in row.key for row in prof.key_averages())


SMALL = tconfig.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=32)
INITS = {
    "bert": (tbert.init_bert_params, (SMALL,), {}),
    "stonkgs": (tstonkgs.init_stonkgs_params,
                (tconfig.STonKGsConfig(bert=SMALL, kg_vocab_size=50, text_len=8, entity_len=8,
                                       num_labels=3),),
                {"with_classifier": True}),
    "protstonkgs": (tprot.init_protstonkgs_params, (tconfig.ProtSTonKGsConfig(
        trunk=tconfig.BigBirdConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                                    num_attention_heads=2, intermediate_size=64,
                                    max_position_embeddings=64, block_size=4,
                                    num_random_blocks=1),
        lm=SMALL, prot=tconfig.BertConfig(vocab_size=30, hidden_size=16, num_hidden_layers=1,
                                          num_attention_heads=2, intermediate_size=32,
                                          max_position_embeddings=16),
        lm_vocab_size=64, kg_vocab_size=50, prot_vocab_size=30, kg_start_idx=12,
        prot_start_idx=16, seq_len=32),), {}),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_fast_init_matches_the_init_tree(name):
    fn, args, kw = INITS[name]
    want = tree_flatten_with_path(fn(torch.Generator().manual_seed(0), *args, **kw))
    got = tree_flatten_with_path(tinit.fast_init(fn, torch.Generator().manual_seed(0), *args,
                                                 seed=1, device="cpu", **kw))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert got[k].device.type == "cpu"
    again = tree_flatten_with_path(tinit.fast_init(fn, torch.Generator().manual_seed(5), *args,
                                                   seed=1, device="cpu", **kw))
    other = tree_flatten_with_path(tinit.fast_init(fn, torch.Generator().manual_seed(0), *args,
                                                   seed=2, device="cpu", **kw))
    floats = [k for k in want if want[k].is_floating_point()]
    assert all(torch.equal(got[k], again[k]) for k in want)   # the seed decides
    assert not all(torch.equal(got[k], other[k]) for k in floats)
    flat = torch.cat([got[k].flatten() for k in floats])
    assert abs(float(flat.std()) - 0.02) < 2e-3
    ints = [k for k in want if not want[k].is_floating_point()]
    assert all(int(got[k].abs().sum()) == 0 for k in ints)


def test_fast_random_like_fills_in_leaf_order_as_jax():
    """The same numpy stream as the JAX package's ``fast_random_like``:
    floats from N(0, std^2) in leaf order, integers zero."""
    from stonkgs_tpu.utils.init import fast_random_like as jfast

    import jax

    shapes = {"a": torch.empty((3, 4), device="meta"),
              "b": [torch.empty((5,), device="meta", dtype=torch.int32),
                    torch.empty((2, 2), device="meta")]}
    got = tinit.fast_random_like(shapes, seed=3, std=0.5, device="cpu")
    want = jfast({"a": jax.ShapeDtypeStruct((3, 4), np.float32),
                  "b": [jax.ShapeDtypeStruct((5,), np.int32),
                        jax.ShapeDtypeStruct((2, 2), np.float32)]}, seed=3, std=0.5)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    np.testing.assert_array_equal(got["b"][1].numpy(), np.asarray(want["b"][1]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_fast_init_refuses_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinit.fast_random_like({"a": torch.empty(2, device="meta")})


def test_version_matches_jax():
    assert tversion.VERSION == jversion.VERSION
    assert tversion.get_version() == jversion.get_version()
    assert tversion.get_git_hash() == jversion.get_git_hash()
    assert tversion.get_version(with_git_hash=True) == (
        f"{tversion.VERSION}-{tversion.get_git_hash()}")
    import stonkgs_tpu_torch

    assert stonkgs_tpu_torch.__version__ == tversion.VERSION
    assert stonkgs_tpu_torch.get_version is tversion.get_version


@pytest.mark.parametrize("b1, b2, eps", [(0.9, 0.999, 1e-8), (0.8, 0.99, 1e-6)])
def test_make_optimizer_matches_jax(b1, b2, eps):
    """The port's ``make_optimizer`` against the JAX package's optax chain
    over three updates (weight decay, a clip that acts) within 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax

    from stonkgs_tpu.train.optimizer import make_optimizer as jmake
    from stonkgs_tpu_torch.train import optimizer as topt
    from stonkgs_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    steps = [{k: rng.normal(size=v.shape).astype(np.float32) * s for k, v in params.items()}
             for s in (3.0, 0.1, 1.0)]
    kw = dict(learning_rate=1e-2, total_steps=10, weight_decay=0.01, b1=b1, b2=b2, eps=eps,
              max_grad_norm=1.0)
    tx = jmake(None, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in steps:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    ttx = topt.make_optimizer(None, fused=True, **kw)
    assert (ttx.b1, ttx.b2, ttx.eps, ttx.max_grad_norm) == (b1, b2, eps, 1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = ttx.init(tp)
    for g in steps:
        ttx.update_and_apply([torch.from_numpy(g[k]) for k in tp], st, tree_leaves(tp))
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_trainable_mask_and_train_state_tree_match_jax():
    from stonkgs_tpu.train.optimizer import trainable_mask as jmask
    from stonkgs_tpu_torch.train import optimizer as topt
    from stonkgs_tpu_torch.train import pretraining as tpre

    params = {"trunk": {"a": np.zeros(2), "b": [np.zeros(1), np.zeros(1)]},
              "lm_backbone": {"c": np.zeros(3)}, "kg_backbone": np.zeros(4),
              "cls": {"d": np.zeros(1)}}
    got = topt.trainable_mask(params)
    assert got == jmask(params)
    assert got["trunk"]["b"] == ["train", "train"] and got["kg_backbone"] == "frozen"
    state = tpre.TrainState(step=3, params={"x": 1}, opt_state={"count": 3}, seed=7)
    assert state.tree() == {"step": 3, "params": {"x": 1}, "opt_state": {"count": 3},
                            "seed": 7}


def test_init_embedding_params_matches_the_jax_layout():
    import jax

    from stonkgs_tpu import config as jconfig
    from stonkgs_tpu.models import bert as jbert

    want = jbert.init_embedding_params(jax.random.PRNGKey(0), jconfig.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=32))
    got = tbert.init_embedding_params(torch.Generator().manual_seed(0), SMALL)
    assert list(got) == list(want)
    for k in want:
        gk = got[k] if k != "layer_norm" else got[k]["scale"]
        wk = want[k] if k != "layer_norm" else want[k]["scale"]
        assert tuple(gk.shape) == tuple(wk.shape), k
    # init_bert_params draws its embeddings through it, first
    full = tbert.init_bert_params(torch.Generator().manual_seed(0), SMALL)
    assert all(torch.equal(full["embeddings"][k], got[k])
               for k in ("word_embeddings", "position_embeddings", "token_type_embeddings"))
