"""The work counters against counts made by hand from the published
shapes."""

import json

import pytest

from portbench.harness import work
from portbench.harness.spec import BENCH_DIR

STONKGS = json.loads((BENCH_DIR / "configs" / "stonkgs-base.json").read_text())
PROT = json.loads((BENCH_DIR / "configs" / "protstonkgs-base.json").read_text())


def test_stonkgs_row_is_143_gflop_less_the_cls_only_layer():
    h, i = 768, 3072
    layer = lambda s: 2 * s * (4 * h * h + 2 * h * i) + 4 * s * s * h  # noqa: E731
    full = 12 * layer(256) + 12 * layer(512) + 2 * h * h
    assert full / 1e9 == pytest.approx(142.5, abs=0.1)  # bench.py: 143
    # the last trunk layer at [CLS] alone: K and V over 512 positions, the
    # rest of the layer for one, one attention row
    cls = 2 * 512 * 2 * h * h + 2 * (2 * h * h + 2 * h * i) + 4 * 512 * h
    want = full - layer(512) + cls
    assert work.embed_flops_per_row(STONKGS) == pytest.approx(want, rel=1e-12)
    assert want / 1e9 == pytest.approx(135.7, abs=0.1)


def test_stonkgs_example_trains_backbone_forward_and_trunk_three_times():
    h, i, v, kg = 768, 3072, 28996, 100_000
    layer = lambda s: 2 * s * (4 * h * h + 2 * h * i) + 4 * s * s * h  # noqa: E731
    heads = 2 * 76 * h * h + 2 * 38 * h * v + 2 * 38 * h * kg + 2 * h * h + 4 * h
    want = 12 * layer(256) + 3 * (12 * layer(512) + heads)
    assert work.train_flops_per_example(STONKGS) == pytest.approx(want, rel=1e-12)


def test_protstonkgs_row():
    h, i = 768, 3072
    lm = lambda s: 2 * s * (4 * h * h + 2 * h * i) + 4 * s * s * h  # noqa: E731
    ph, pi, ps = 1024, 4096, 3072
    prot = 2 * ps * (4 * ph * ph + 2 * ph * pi) + 4 * ps * ps * ph
    # BigBird at S=4096, block 64, 3 random: two global query blocks of 64
    # rows over every key, 62 middle blocks over 8 blocks of keys
    cols = 2 * 64 * 4096 + 62 * 64 * 512
    trunk = 2 * 4096 * (4 * h * h + 2 * h * i) + 4 * cols * h
    cls = 2 * 4096 * 2 * h * h + 2 * (2 * h * h + 2 * h * i) + 4 * 4096 * h
    want = (12 * 3 * lm(256) + 30 * prot + 2 * ps * ph * h + 11 * trunk + cls + 2 * h * h)
    assert work.embed_flops_per_row(PROT) == pytest.approx(want, rel=1e-12)


def test_op_calls_per_batch_and_step():
    calls = lambda cfg, mode, b: {  # noqa: E731
        op: sum(c for o, _, _, c in work.op_calls(cfg, mode, b) if o == op)
        for op, _, _, _ in work.op_calls(cfg, mode, b)}
    assert calls(STONKGS, "embed", 128) == {"ffn_ln_block": 23, "attention_infer": 23}
    assert calls(STONKGS, "pretrain", 32) == {"attention_train": 36, "ffn_train": 36}
    assert calls(PROT, "embed", 8) == {"ffn_ln_block": 53, "attention_infer": 42,
                                       "bigbird_fwd": 11}


def test_bounds_match_the_kernel_tables():
    # PERF.md's bounds: the STonKGs trunk's FFN block at M=65,536 0.625 ms
    # of operations; the trunk attention at B=128 S=512 0.120 ms of bytes
    peak, bw = work.PEAKS["bf16_flops_per_s"], work.PEAKS["hbm_bytes_per_s"]
    f, b = work.ffn_ln_block(65536, 768, 3072)
    assert f / peak * 1e3 == pytest.approx(0.625, abs=0.001) and b / bw < f / peak
    f, b = work.attention_infer(128, 512, 12, 64, True)
    assert b / bw * 1e3 == pytest.approx(0.120, abs=0.001) and f / peak < b / bw
    f, b = work.bigbird_fwd(8, 4096, 12, 64, 64, 3)
    assert f / 1e9 == pytest.approx(49.9, abs=0.1)
    f, _ = work.attention_train_bwd(32, 512, 12, 64, True)
    assert f / peak * 1e3 == pytest.approx(0.065, abs=0.001)
    bounds = work.op_bounds(STONKGS, "embed", 128)
    assert bounds["ffn_ln_block"]["bound_s"] == pytest.approx(
        (11 * 0.625 + 12 * 0.3127) * 1e-3, rel=1e-3)


@pytest.mark.parametrize("traffic,cfg", [("bulk-b128", STONKGS), ("bulk-b8", PROT),
                                         ("pretrain-b32", STONKGS)])
def test_every_seed_draws_the_same_shapes(traffic, cfg):
    from portbench.harness import model, traffic as gen

    tr = json.loads((BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
    seq = sum(s["len"] for s in tr["segments"])
    assert seq == (cfg.get("seq_len") or cfg["text_len"] + cfg["entity_len"])
    shapes = []
    for seed in (1, 2 ** 31 + 5):
        f = gen.features(tr, seed, 64, cfg["kg_vocab_size"], model.special_ids(cfg),
                         token_types=cfg["model"] == "stonkgs")
        shapes.append({k: v.shape for k, v in f.items()})
        assert f["input_ids"].min() >= 0
        if "ent_masked_lm_labels" in f:
            # 38 masked entity positions a row: the program's gather takes 38
            assert ((f["ent_masked_lm_labels"] != -100).sum(1) == 38).all()
            assert ((f["masked_lm_labels"] != -100).sum(1) <= 38).all()
    assert shapes[0] == shapes[1]
