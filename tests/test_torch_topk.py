"""The port's score + top-k against the JAX package's two implementations.

On the CPU the port's ``score_topk`` is its plain version; it is held
against ``score_topk_xla`` and against the Pallas kernel in interpret mode
(``tile_n=128``; that path declines N < 2 * tile_n, so its cases use
N >= 256), on the cases of the JAX package's own kernel tests. Scores agree
within rtol 1e-5 (one f32 product summed in another order) and indices
exactly. ``test_torch_topk_kernel.py`` holds the CUDA kernel against the
plain version on the same cases. With bf16 docs and f32 queries the
queries are rounded as JAX's dispatcher rounds them: cast to the docs'
dtype where its Pallas kernel takes the shape, unrounded at k > 256
(``score_topk_xla``); at N < 2 * tile_n and Q > 1024 the port casts where
JAX does not (TPU tuning the port does not copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_topk_kernel import CASES, case
from twotowers_tpu.kernels.pallas_topk import score_topk_pallas
from twotowers_tpu.ops.topk_score import score_topk as jax_score_topk
from twotowers_tpu.ops.topk_score import score_topk_xla
from twotowers_tpu_torch.kernels import topk
from twotowers_tpu_torch.ops import topk_score
from twotowers_tpu_torch.ops.topk_score import (score_topk, score_topk_reference,
                                                score_topk_torch, score_topk_unrounded)


def _jax_paths(docs, queries, k, n_docs):
    d, q = jnp.asarray(docs), jnp.asarray(queries)
    out = {"xla": score_topk_xla(d, q, k, n_docs)}
    if docs.shape[0] >= 256:
        out["pallas"] = score_topk_pallas(d, q, k, n_docs, tile_n=128, interpret=True)
    return out


@pytest.mark.parametrize("name", CASES)
def test_cpu_path_matches_jax(name):
    docs, queries, k, n_docs = case(name)
    got_s, got_i = score_topk(torch.from_numpy(docs), torch.from_numpy(queries), k, n_docs)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == got_i.shape == (queries.shape[0], k)
    for path, (want_s, want_i) in _jax_paths(docs, queries, k, n_docs).items():
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                                   err_msg=path)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=path)
    if name == "n_docs":
        assert got_i.max() < 300
    if name in ("ties", "zero-query"):  # equal scores go to the lower index
        np.testing.assert_array_equal(got_i.numpy(), np.tile(np.arange(k), (len(queries), 1)))


def test_bf16_docs_cast_queries_like_pallas(np_rng):
    docs = np_rng.normal(size=(512, 32)).astype(np.float32)
    queries = np_rng.normal(size=(3, 32)).astype(np.float32)
    got_s, got_i = score_topk_reference(torch.from_numpy(docs).bfloat16(),
                                        torch.from_numpy(queries), 8)
    want_s, want_i = score_topk_pallas(jnp.asarray(docs, jnp.bfloat16), jnp.asarray(queries),
                                       8, tile_n=128, interpret=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n,dim,k,route", [
    (1000, 128, 10, "kernel"), (1000, 128, 256, "kernel"), (300, 64, 300, "torch"),
    (1000, 128, 257, "torch"), (1000, 1025, 10, "torch"), (100, 16, 101, "torch"),
    (1, 8, 1, "kernel")])
def test_route_rule_on_the_card(monkeypatch, n, dim, k, route):
    """Off the CPU the route is chosen by shape before any launch: the
    kernel for 1 <= k <= min(256, N) and D <= 1024, else the torch route,
    counted apart. Tensors on the meta device stand in for the card's."""
    taken = []
    monkeypatch.setattr(topk_score, "score_topk_cuda", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(topk_score, "score_topk_plain", lambda *a: taken.append("torch"))
    before = topk_score.TORCH_ROUTE_CALLS
    score_topk(torch.empty(n, dim, device="meta"), torch.empty(2, dim, device="meta"), k)
    assert taken == [route]
    assert topk_score.TORCH_ROUTE_CALLS == before + (route == "torch")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_negative_k_raises_as_jax_does(np_rng, monkeypatch, device):
    """k < 0 raises ValueError before any route is chosen, as
    ``lax.top_k`` does; k = 0 gives empty (Q, 0) results in both packages.
    Tensors on the meta device stand in for the card's."""
    docs = np_rng.normal(size=(10, 8)).astype(np.float32)
    queries = np_rng.normal(size=(2, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="nonnegative"):
        jax_score_topk(jnp.asarray(docs), jnp.asarray(queries), -1, use_pallas=False)
    taken = []
    monkeypatch.setattr(topk_score, "score_topk_cuda", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(topk_score, "score_topk_torch", lambda *a: taken.append("torch"))
    d, q = torch.from_numpy(docs).to(device), torch.from_numpy(queries).to(device)
    for k in (-1, -3):
        with pytest.raises(ValueError, match="nonnegative"):
            score_topk(d, q, k)
    assert taken == []
    got_s, got_i = score_topk(torch.from_numpy(docs), torch.from_numpy(queries), 0)
    want_s, want_i = jax_score_topk(jnp.asarray(docs), jnp.asarray(queries), 0, use_pallas=False)
    assert got_s.shape == got_i.shape == np.asarray(want_s).shape == np.asarray(want_i).shape \
        == (2, 0)


def test_torch_route_matches_jax_for_large_k(np_rng):
    """k = 300 > 256, the shape the kernel refuses: the torch route gives
    score_topk_xla's results."""
    docs = np_rng.normal(size=(700, 16)).astype(np.float32)
    queries = np_rng.normal(size=(3, 16)).astype(np.float32)
    got_s, got_i = topk_score.score_topk_torch(torch.from_numpy(docs), torch.from_numpy(queries),
                                               300, 650)
    want_s, want_i = score_topk_xla(jnp.asarray(docs), jnp.asarray(queries), 300, 650)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _bf16_case(rng, n, dim, q):
    """Normal docs rounded to bf16 (as f32 numpy) and f32 queries: the
    inputs on which the two rounding rules part."""
    docs = rng.normal(size=(n, dim)).astype(np.float32)
    docs = torch.from_numpy(docs).bfloat16().float().numpy()
    return docs, rng.normal(size=(q, dim)).astype(np.float32)


def _assert_same(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-5,
                               err_msg=err_msg)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]), err_msg=err_msg)


def _differ(a, b):
    return not (np.allclose(np.asarray(a[0]), np.asarray(b[0]), rtol=1e-5)
                and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))


def test_bf16_docs_at_large_k_are_scored_unrounded_as_jax_does(np_rng):
    """k = 300 > 256 with bf16 docs and f32 queries: JAX sends the call to
    score_topk_xla, whose product promotes the docs to f32 and does not
    round the queries. The CPU route, the torch route and the plain
    function score_topk_unrounded give its indices exactly; the casting
    plain version does not."""
    docs, queries = _bf16_case(np_rng, 700, 16, 3)
    d, q = jnp.asarray(docs, jnp.bfloat16), jnp.asarray(queries)
    want = {"score_topk": jax_score_topk(d, q, 300, 650), "xla": score_topk_xla(d, q, 300, 650)}
    td, tq = torch.from_numpy(docs).bfloat16(), torch.from_numpy(queries)
    got = {"cpu route": score_topk(td, tq, 300, 650),
           "torch route": score_topk_torch(td, tq, 300, 650),
           "unrounded": score_topk_unrounded(td, tq, 300, 650)}
    for name, out in got.items():
        assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32
        for path, ref in want.items():
            _assert_same(out, ref, f"{name} against {path}")
    assert _differ(score_topk_reference(td, tq, 300, 650), want["xla"])


def test_torch_route_keeps_the_pallas_cast_above_the_kernels_width():
    """D = 1040 > 1024, k = 10: the kernel declines, the torch route casts
    as JAX's Pallas kernel does, which takes the shape (N = 4096 = two
    tiles of its default 2048; interpret mode on the CPU)."""
    docs, queries = _bf16_case(np.random.default_rng(5), 4096, 1040, 3)
    d, q = jnp.asarray(docs, jnp.bfloat16), jnp.asarray(queries)
    want = jax_score_topk(d, q, 10)
    _assert_same(want, score_topk_pallas(d, q, 10, interpret=True), "pallas")
    td, tq = torch.from_numpy(docs).bfloat16(), torch.from_numpy(queries)
    before = topk_score.TORCH_ROUTE_CALLS
    _assert_same(score_topk_torch(td, tq, 10), want, "torch route")
    assert topk_score.TORCH_ROUTE_CALLS == before + 1
    _assert_same(score_topk(td, tq, 10), want, "cpu route")
    assert _differ(score_topk_xla(d, q, 10), want)


@pytest.mark.parametrize("clause,n,q", [("N < 2 * tile_n", 700, 3), ("Q > 1024", 4096, 1025)])
def test_port_casts_where_the_tpu_kernel_declines(np_rng, clause, n, q):
    """Deviation, on purpose: the TPU kernel declines N < 2 * tile_n and
    Q > 1024 (VMEM sizing), so JAX's score_topk gives score_topk_xla's
    unrounded result. The port's kernel takes both shapes and casts, and
    its CPU route follows it: the Pallas rule's result (the Pallas kernel
    at tile_n=128 for the N clause; at Q > 1024 it declines every tile, so
    score_topk_xla of the queries cast to bf16)."""
    docs, queries = _bf16_case(np_rng, n, 16, q)
    d, q_ = jnp.asarray(docs, jnp.bfloat16), jnp.asarray(queries)
    jax_out = jax_score_topk(d, q_, 10)
    _assert_same(jax_out, score_topk_xla(d, q_, 10), "JAX takes the XLA route")
    assert score_topk_pallas(d, q_, 10, interpret=True) is None
    if clause == "Q > 1024":
        pallas_rule = score_topk_xla(d, q_.astype(jnp.bfloat16), 10)
    else:
        pallas_rule = score_topk_pallas(d, q_, 10, tile_n=128, interpret=True)
    td, tq = torch.from_numpy(docs).bfloat16(), torch.from_numpy(queries)
    assert topk_score.kernel_takes(td, 10)
    got = score_topk(td, tq, 10)
    _assert_same(got, pallas_rule, clause)
    assert _differ(got, jax_out)


def chunk_candidates(docs, queries, s, k):
    """Pass 1's lists by the plain version: the docs cut into ``s`` chunks
    (as even as they go), each chunk's top-k by ``score_topk_reference``
    with its indices moved to the whole matrix's, a chunk shorter than k
    padded with (-inf, NO_INDEX). Returns (Q, s, k) tensors."""
    lists_v, lists_i = [], []
    for rows in np.array_split(np.arange(docs.shape[0]), s):
        real = min(k, len(rows))
        v, i = score_topk_reference(torch.from_numpy(docs[rows]), torch.from_numpy(queries), real)
        pad = (queries.shape[0], k - real)
        lists_v.append(torch.cat([v, torch.full(pad, -torch.inf)], 1))
        lists_i.append(torch.cat([i + int(rows[0]), torch.full(pad, topk.NO_INDEX,
                                                                 dtype=torch.int32)], 1))
    return torch.stack(lists_v, 1), torch.stack(lists_i, 1)


MERGE_PROPERTY_CASES = [(s, k) for s, k in ((1, 5), (3, 7), (17, 10), (33, 64), (50, 1),
                                            (300, 4))]


@pytest.mark.parametrize("kind", ["random", "tied", "integer"])
@pytest.mark.parametrize("s,k", MERGE_PROPERTY_CASES)
def test_merge_of_chunk_topks_is_the_topk(kind, s, k):
    """Pass 2's plain version over the chunks' top-k lists gives the top-k
    over all docs: bit for bit the plain version's, and the JAX package's
    ``score_topk`` exactly. The values are multiples of 1/256 in [-1, 1]
    ("random": few ties), integers in [-2, 2] (many) or one tied column,
    so every f32 sum is exact whatever a matmul's blocking: a chunk's
    scores are the whole matrix's. Chunks of 3 docs at S=300 leave most
    lists padded."""
    rng = np.random.default_rng(s * 100 + k)
    n, dim = 900, 16
    if kind == "tied":
        docs = np.zeros((n, dim), np.float32)
        docs[:, 0] = 1.0
        queries = np.abs(rng.integers(-2, 3, size=(3, dim))).astype(np.float32) + 1
    else:
        scale, top = (256.0, 256) if kind == "random" else (1.0, 2)
        docs = (rng.integers(-top, top + 1, size=(n, dim)) / scale).astype(np.float32)
        queries = (rng.integers(-top, top + 1, size=(3, dim)) / scale).astype(np.float32)
    cand_v, cand_i = chunk_candidates(docs, queries, s, k)
    got_v, got_i = topk.merge_topk_reference(cand_v, cand_i)
    want_v, want_i = score_topk_reference(torch.from_numpy(docs), torch.from_numpy(queries), k)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)
    jax_v, jax_i = jax_score_topk(jnp.asarray(docs), jnp.asarray(queries), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jax_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax_i))
    if kind == "tied":  # every score ties: the first k docs, in order
        np.testing.assert_array_equal(got_i.numpy(), np.tile(np.arange(k), (3, 1)))


# a bar rule that samples at this test's size: about 1,024 docs, then 512
BAR_RULE = {"max_docs": 1024, "min_docs": 512, "min_ratio": 2, "min_tiles": 1}


def barred_composition(docs, queries, k, split_len, n_docs):
    """The plain version of a barred call, through the wrapper's own
    ``sample_topk``: each run is the plain per-split top-k among the pairs
    at or before its bar (``candidates_reference``), then the plain merge.
    The sample runs (tiles spread over the docs, barred in turn) give each
    query's k-th pair as the bar of the run over every split. Returns the
    result, the bar and the sample plans."""
    def launch(n_splits, s_len, s_docs, bar):
        cands = topk.candidates_reference(docs, queries, k, s_len, n_docs, bar=bar,
                                          split_docs=s_docs)
        assert cands[0].shape[1] == n_splits
        plans.append((s_len, s_docs))
        return topk.merge_topk_reference(*cands)

    plans = []
    n = docs.shape[0]
    n_splits = -(-n // split_len)
    top = topk.sample_topk(launch, queries.shape[0], k, n, n_splits, split_len, split_len,
                           **BAR_RULE)
    bar = topk.kth(top, k)
    return launch(n_splits, split_len, split_len, bar), bar, plans


def _bar_case(kind, rng, n, dim, q):
    """Inputs whose f32 sums are exact in any order (so a chunk's scores
    are the whole matrix's): multiples of 1/256 in [-1, 1], integers in
    [-2, 2], one tied column, or one column of -0.0, +0.0 (12 rows) and -1
    against ones."""
    if kind == "tied":
        docs = np.zeros((n, dim), np.float32)
        docs[:, 0] = 1.0
        return docs, np.abs(rng.integers(-2, 3, size=(q, dim))).astype(np.float32) + 1
    if kind == "signed-zero":  # one column: a -0.0 doc scores -0.0
        docs = -np.ones((n, 1), np.float32)
        docs[rng.choice(n, 10, replace=False)] = 0.0
        docs[(docs == 0) & (rng.random((n, 1)) < 0.5)] = -0.0
        docs[[3, 5]] = [[-0.0], [0.0]]
        return docs, np.ones((q, 1), np.float32)
    scale, top = (256.0, 256) if kind == "random" else (1.0, 2)
    docs = (rng.integers(-top, top + 1, size=(n, dim)) / scale).astype(np.float32)
    return docs, (rng.integers(-top, top + 1, size=(q, dim)) / scale).astype(np.float32)


BAR_COMPOSITION_CASES = [
    ("random", 20, None), ("random", 64, None), ("integer", 20, None), ("integer", 64, 700),
    ("tied", 64, None), ("signed-zero", 20, None), ("random", 64, 600), ("integer", 64, 40)]


@pytest.mark.parametrize("kind,k,n_docs", BAR_COMPOSITION_CASES)
@pytest.mark.parametrize("split_len", [512, 768])
def test_barred_composition_is_the_topk(kind, k, n_docs, split_len):
    """A barred call's plain version (a sample run's k-th pair bars pass 1,
    the sample run barred in turn by a smaller one, then the plain merge)
    gives the plain version's result bit for bit and the JAX package's
    ``score_topk`` exactly: k docs of the sample rank at or before the
    bar, so no doc after it is in the top-k. n_docs = 40 < k = 64 makes
    the sample's k-th pair a masked row (-1e30). The JAX package's XLA
    top-k ranks +0.0 before -0.0 where the port ties them by index, so
    signed zeros (all among the top-k here) are held against it by value
    and by the set of indices."""
    rng = np.random.default_rng(k * 7 + split_len + len(kind))
    n = 4000
    docs, queries = _bar_case(kind, rng, n, 16, 6)
    td, tq = torch.from_numpy(docs), torch.from_numpy(queries)
    (got_v, got_i), bar, plans = barred_composition(td, tq, k, split_len, n_docs)
    # the innermost sample, the sample, then every split: first tiles only
    assert len(plans) == 3 and plans[-1] == (split_len, split_len)
    assert plans[1][1] == plans[0][1] == topk.BATCH_TILE_N < split_len
    want_v, want_i = score_topk_reference(td, tq, k, n_docs)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)
    jax_v, jax_i = jax_score_topk(jnp.asarray(docs), jnp.asarray(queries), k, n_docs)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jax_v))
    if kind == "signed-zero":
        assert bool(torch.signbit(got_v[got_v == 0]).any())
        assert bool((got_v[:, -1] < 0).all())  # every zero is in the top-k
        for row in range(6):
            assert set(got_i[row].tolist()) == set(np.asarray(jax_i)[row].tolist())
    else:
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax_i))
    if n_docs is not None and n_docs < k:  # the bar is a masked row's pair
        assert bool((bar[0] == np.float32(-1e30)).all()) and bool((bar[1] >= n_docs).all())
    if kind == "tied":  # the bar is doc k-1: the first k docs, in order
        assert bool((bar[1] == k - 1).all())
        np.testing.assert_array_equal(got_i.numpy(), np.tile(np.arange(k), (6, 1)))


@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [10, 256])
def test_bf16_docs_at_two_to_four_queries_match_jax(q, k):
    """The shapes of the bf16 Q = 2-4 pass on the tensor cores
    (``score_topk_stream_mma``; on the CPU its plain version): bf16 docs,
    N = 640, D = 128, inputs from a numpy seed, queries already
    bf16-representable so that the Pallas kernel's cast and
    ``score_topk_xla``'s unrounded product agree. Scores within rtol 1e-5
    (f32 sums in another order), indices exactly, against both."""
    rng = np.random.default_rng(100 * q + k)
    docs = torch.from_numpy(rng.normal(size=(640, 128)).astype(np.float32)).bfloat16()
    queries = torch.from_numpy(rng.normal(size=(q, 128)).astype(np.float32)).bfloat16().float()
    got = score_topk(docs, queries, k)
    assert got[0].shape == got[1].shape == (q, k)
    d = jnp.asarray(docs.float().numpy(), jnp.bfloat16)
    qj = jnp.asarray(queries.numpy())
    _assert_same(got, score_topk_pallas(d, qj, k, tile_n=128, interpret=True), "pallas")
    _assert_same(got, score_topk_xla(d, qj, k), "xla")


@pytest.mark.parametrize("q", [5, 33, 64])
@pytest.mark.parametrize("k", [1, 10, 14])
def test_f32_batches_at_narrow_k_match_jax(q, k):
    """The shapes of the f32 ring pass (``score_topk_tiles_ring``: Q >= 5,
    k <= WIDE_K; on the CPU its plain version): f32 docs, N = 767, D = 100
    (not a multiple of 4: the ring's 4-byte copies), rows past n_docs = 700
    masked, inputs from a numpy seed. Scores within rtol 1e-5 (f32 sums in
    another order), indices exactly, against the Pallas kernel in interpret
    mode and ``score_topk_xla``."""
    assert topk.ring_takes(torch.float32, q, k)
    rng = np.random.default_rng(1000 * q + k)
    docs = rng.normal(size=(767, 100)).astype(np.float32)
    queries = rng.normal(size=(q, 100)).astype(np.float32)
    got = score_topk(torch.from_numpy(docs), torch.from_numpy(queries), k, 700)
    assert got[0].shape == got[1].shape == (q, k) and int(got[1].max()) < 700
    for path, want in _jax_paths(docs, queries, k, 700).items():
        _assert_same(got, want, path)
