"""The operation and byte counts behind the per-layer metrics, against hand
counts at small shapes, and the readers on made-up traces."""

from __future__ import annotations

import types

import pytest

from benchmark import counts, harness
from benchmark.measure import TraceSummary, percentile

PEAK_F32, PEAK_BF16, HBM = 67e12, 989e12, 3.35e12


def test_topk_bound_by_operations_and_by_bytes():
    # Q=256, N=1000, D=8, f32: 2*256*1000*8 = 4,096,000 operations;
    # (1000 + 256) * 8 * 4 + 256 * 10 * 8 = 60,672 bytes
    assert counts.topk_bound_s(1000, 8, 256, 10) == pytest.approx(
        max(4_096_000 / PEAK_F32, 60_672 / HBM))
    assert 4_096_000 / PEAK_F32 > 60_672 / HBM
    # Q=1: (1000 + 1) * 8 * 4 + 1 * 10 * 8 = 32,112 bytes bound it
    assert counts.topk_bound_s(1000, 8, 1, 10) == pytest.approx(32_112 / HBM)
    # the cells' own shapes: 8.64 ms by operations at Q=256, 1.35 by bytes at Q=1
    assert counts.topk_bound_s(8_841_823, 128, 256, 10) == pytest.approx(8.6476e-3, rel=1e-3)
    assert counts.topk_bound_s(8_841_823, 128, 1, 10) == pytest.approx(1.3514e-3, rel=1e-3)


def test_search_flops_by_hand():
    # tower: 2*4*6 + 2*6*6 = 120; scores 2*100*6 = 1,200
    assert counts.search_flops(100, 6, 4, 6) == 1_320


def test_tf_flops_by_hand_at_a_small_shape():
    b, l, e, h, n = 2, 3, 4, 5, 1
    proj = 2 * b * l * e * h                      # 240
    qkvo = 4 * (2 * b * l * h * h)                # 1,200
    attn = 2 * (2 * b * l * l * h)                # scores and weights x values: 360
    ffn = 2 * (2 * b * l * h * 4 * h)             # 2,400
    fwd_text = proj + n * (qkvo + attn + ffn)     # 4,200
    loss = 2 * b * b * h                          # 40
    assert counts.tf_flops(b, l, e, h, n) == 3 * (2 * fwd_text) + 3 * loss
    assert counts.tf_flops(4096, 48, 128, 128, 2) == pytest.approx(1.037e12, rel=1e-3)


def test_lookup_bytes_by_hand():
    # gather of 10 ids from a 7 x 4 f32 table into bf16: 40 + 112 + 80
    assert counts.gather_bytes(10, 7, 4, "float32", "bfloat16") == 232
    # scatter-add of 10 bf16 rows into a 7 x 4 f32 table: 80 + 40 + 112
    assert counts.scatter_add_bytes(10, 7, 4, "bfloat16", "float32") == 232
    assert counts.lookup_bound_s(2, 10, 7, 4, "float32", "bfloat16") == pytest.approx(
        2 * 464 / HBM)


def _run(**kw):
    tracer = types.SimpleNamespace(summary=kw.pop("summary", None))
    return types.SimpleNamespace(work=kw.pop("work", {}), spans=kw.pop("spans", {}),
                                 calls=kw.pop("calls", {}), tracer=tracer)


def _reader(name):
    return harness.load_reader(harness.BENCH_DIR / "metrics" / f"{name}.py")


def _summary(kernels, window=2.0, busy=1.5):
    return TraceSummary(window, busy, kernels, {k: 1 for k in kernels}, {})


def test_topk_roofline_reader():
    call = (1000, 8, 256, 10, "float32")
    bound = counts.topk_bound_s(*call)
    summary = _summary({"void score_topk_tiles_ring<8>(...)": 3 * bound,
                        "void score_topk_merge_final(...)": bound, "other": 5.0})
    assert _reader("topk_roofline")(_run(summary=summary, calls={"score_topk": [call] * 2})) \
        == pytest.approx(50.0)
    assert _reader("topk_roofline")(_run(summary=summary)) is None
    assert _reader("topk_roofline")(_run(calls={"score_topk": [call]})) is None


def test_search_mfu_reader():
    work = dict(queries=1000, window_s=2.0, n_docs=100, dim=6, emb=4, hid=6)
    assert _reader("search_mfu")(_run(work=work)) == pytest.approx(
        100 * 1000 * 1320 / 2.0 / PEAK_F32)
    assert _reader("search_mfu")(_run()) is None
    traced = dict(work, traced_queries=200)
    assert _reader("search_mfu")(_run(work=traced, summary=_summary({}, window=0.5))) == \
        pytest.approx(100 * 800 * 1320 / 1.5 / PEAK_F32)


def test_train_mfu_and_lookup_roofline_readers():
    work = dict(steps=10, window_s=0.5, step_flops=1e12, traced_steps=4, traced_s=0.1,
                lookup_bound_s=1e-4)
    # the profiled epoch's 4 steps and 0.1 s are left out
    assert _reader("train_mfu")(_run(work=work)) == pytest.approx(100 * 6e12 / 0.4 / PEAK_BF16)
    summary = _summary({"gather_rows_kernel<float>": 2e-4, "scatter_chunks<bf16>": 3e-4,
                        "scatter_spans": 1e-4, "cub::DeviceRadixSortOnesweepKernel": 2e-4,
                        "ampere_sgemm": 9.0})
    assert _reader("lookup_roofline.train")(_run(work=work, summary=summary)) == \
        pytest.approx(100 * 4e-4 / 8e-4)
    assert _reader("lookup_roofline.train")(_run(work=work)) is None


def test_idle_and_encode_readers():
    summary = _summary({"k": 1.0}, window=4.0, busy=3.0)
    for name in ("device_idle.serve", "device_idle.train"):
        assert _reader(name)(_run(summary=summary)) == pytest.approx(25.0)
        assert _reader(name)(_run()) is None
    spans = [0.001, 0.003, 0.002]
    assert _reader("encode_ms.batch")(_run(spans={"encode": spans})) == pytest.approx(2.0)
    assert percentile(range(101), 95) == pytest.approx(95.0)
