"""The port's data factory against the JAX package's, on the same seeds and
files: the synthetic generator and its expansion, the selectors and
samplers, ``build_triplets`` for every preset on the MS MARCO-shaped
fixture, the format converters, the local readers, the written TSV and
parquet files, ``get_ms_marco_dataset`` with a stub ``datasets`` module and
both CLIs. Frames and files must be equal, not close: both packages draw
from the same ``random.Random(seed)`` in the same order.
"""

import json
import sys
import types
from pathlib import Path

import pandas as pd
import pytest
import yaml

import twotowers_tpu.data.factory as jax_factory
import twotowers_tpu.data.factory.build_dataset as jax_build
import twotowers_tpu.data.factory.readers as jax_readers
import twotowers_tpu.data.factory.synthetic_dataset_gen as jax_gen
import twotowers_tpu_torch.data.factory as factory
import twotowers_tpu_torch.data.factory.build_dataset as build
import twotowers_tpu_torch.data.factory.readers as readers
import twotowers_tpu_torch.data.factory.synthetic_dataset_gen as gen

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "msmarco_raw.parquet"
PRESETS = sorted((ROOT / "presets").glob("*.yml"))


@pytest.fixture(scope="module")
def msmarco():
    return pd.read_parquet(FIXTURE)


@pytest.fixture
def data_dirs(tmp_path, monkeypatch):
    """Point both packages' ``data/{raw,processed}`` tree at ``tmp_path``
    (what ``TWOTOWERS_DATA_DIR`` does at import), one tree each."""
    dirs = {}
    for name, package in (("jax", "twotowers_tpu"), ("torch", "twotowers_tpu_torch")):
        root = tmp_path / name / "data"
        for module in ("readers", "convert", "synthetic"):
            mod = sys.modules[f"{package}.data.factory.{module}"]
            for attr, value in (("DATA_DIR", root), ("RAW_DATA_DIR", root / "raw"),
                                ("PROCESSED_DATA_DIR", root / "processed"),
                                ("RAW_PARQUET_DIR", root / "raw" / "parquet")):
                if hasattr(mod, attr):
                    monkeypatch.setattr(mod, attr, value)
        dirs[name] = root
    return dirs


def test_public_names_match_the_jax_package():
    assert factory.__all__ == jax_factory.__all__
    for name in factory.__all__:
        assert callable(getattr(factory, name)) == callable(getattr(jax_factory, name)), name


def test_data_dir_follows_the_environment(monkeypatch, tmp_path):
    import importlib

    monkeypatch.setenv("TWOTOWERS_DATA_DIR", str(tmp_path / "elsewhere"))
    try:
        importlib.reload(readers)
        importlib.reload(jax_readers)
        assert readers.DATA_DIR == jax_readers.DATA_DIR == tmp_path / "elsewhere"
        assert readers.RAW_PARQUET_DIR == jax_readers.RAW_PARQUET_DIR
        assert readers.PROCESSED_DATA_DIR == jax_readers.PROCESSED_DATA_DIR
    finally:
        monkeypatch.delenv("TWOTOWERS_DATA_DIR")
        importlib.reload(readers)
        importlib.reload(jax_readers)


# ---- synthetic ----------------------------------------------------------------

@pytest.mark.parametrize("num_pairs,negatives,seed", [
    (1, 1, 0), (50, 1, 0), (50, 3, 7), (200, 1, None)])
def test_generate_synthetic_pairs_equals_jax(num_pairs, negatives, seed):
    if seed is None:  # no seed: each call draws afresh, so only the shape agrees
        got = factory.generate_synthetic_pairs(num_pairs, negatives)
        want = jax_factory.generate_synthetic_pairs(num_pairs, negatives)
        assert got.shape == want.shape and list(got.columns) == list(want.columns)
        return
    got = factory.generate_synthetic_pairs(num_pairs, negatives, seed=seed)
    want = jax_factory.generate_synthetic_pairs(num_pairs, negatives, seed=seed)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == num_pairs * (1 + negatives)


@pytest.mark.parametrize("additional,seed", [(0, 1), (30, 1), (120, 5)])
def test_expand_synthetic_dataset_equals_jax(additional, seed):
    base = jax_factory.generate_synthetic_pairs(40, 1, seed=3)
    got = factory.expand_synthetic_dataset(base.copy(), additional, seed=seed)
    want = jax_factory.expand_synthetic_dataset(base.copy(), additional, seed=seed)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == len(base) + 2 * additional


def test_expand_without_positives_draws_new_pairs():
    negatives_only = pd.DataFrame({"query": ["q"], "document": ["d"], "label": [0]})
    got = factory.expand_synthetic_dataset(negatives_only, 10, seed=2)
    want = jax_factory.expand_synthetic_dataset(negatives_only, 10, seed=2)
    pd.testing.assert_frame_equal(got, want)


def test_written_pairs_tsv_and_triplets_parquet_equal_jax(tmp_path):
    df = jax_factory.generate_synthetic_pairs(30, 2, seed=11)
    df.loc[0, "query"] = "a\ttabbed\nquery"  # sanitised on the way out
    paths = {}
    for name, pkg in (("jax", jax_factory), ("torch", factory)):
        paths[name] = (pkg.write_pairs_tsv(df, tmp_path / name / "pairs.tsv"),
                       pkg.write_triplets_parquet(df, tmp_path / name / "triplets.parquet"))
    assert paths["torch"][0].read_bytes() == paths["jax"][0].read_bytes()
    got, want = (pd.read_parquet(paths[name][1]) for name in ("torch", "jax"))
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["q_text", "d_pos_text", "d_neg_text"]


def test_default_paths_go_under_the_data_dir(data_dirs):
    df = jax_factory.generate_synthetic_pairs(5, 1, seed=0)
    got = factory.write_pairs_tsv(df)
    want = jax_factory.write_pairs_tsv(df)
    assert got == data_dirs["torch"] / "raw" / "pairs.tsv"
    assert want == data_dirs["jax"] / "raw" / "pairs.tsv"
    assert got.read_bytes() == want.read_bytes()


# ---- selectors and samplers --------------------------------------------------

@pytest.mark.parametrize("text,answers", [
    ("The Answer Is HERE somewhere", ["answer is here"]),
    ("nothing relevant", ["answer"]),
    ("text", []),
    ("Numbers 42 too", [42]),
])
def test_answer_in_text_equals_jax(text, answers):
    assert factory.answer_in_text(text, answers) == jax_factory.answer_in_text(text, answers)


@pytest.mark.parametrize("a,b,n,threshold", [
    ("one two three four five six", "one two three four five six", 3, 0.8),
    ("one two three four five six", "one two three four five seven", 3, 0.5),
    ("one two three four five six", "totally different words here", 3, 0.8),
    ("a b", "a b", 3, 0.8),
    ("A B C D", "a b c d", 2, 1.0),
])
def test_ngram_filters_equal_jax(a, b, n, threshold):
    assert factory.ngram_set(a, n) == jax_factory.ngram_set(a, n)
    assert factory.high_ngram_overlap(a, b, n, threshold) == \
        jax_factory.high_ngram_overlap(a, b, n, threshold)


def test_selectors_and_pool_equal_jax(msmarco):
    head = msmarco.head(200)
    got = list(factory.classic_positives(head))
    want = list(jax_factory.classic_positives(head))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["query"], g["positive"], g["answers"]) == \
            (w["query"], w["positive"], w["answers"])
        assert list(g["passages"]["is_selected"]) == list(w["passages"]["is_selected"])
        assert list(g["passages"]["passage_text"]) == list(w["passages"]["passage_text"])
    assert factory.build_inter_query_pool(head) == jax_factory.build_inter_query_pool(head)


@pytest.mark.parametrize("seed", [0, 3])
def test_samplers_draw_jax_sequence(msmarco, seed):
    head = msmarco.head(100)
    pool = factory.build_inter_query_pool(head)
    got = factory.random_inter_query(pool, seed=seed)
    want = jax_factory.random_inter_query(pool, seed=seed)
    assert [got({}) for _ in range(50)] == [want({}) for _ in range(50)]
    assert factory.random_inter_query([], seed=seed)({}) is None
    intra = factory.intra_query_zero_filtered(seed=seed)
    jax_intra = jax_factory.intra_query_zero_filtered(seed=seed)
    contexts = list(factory.classic_positives(head))
    assert [intra(c) for c in contexts] == [jax_intra(c) for c in contexts]
    assert intra({"passages": {"is_selected": [1], "passage_text": ["x"]}}) is None


# ---- build_triplets ------------------------------------------------------------

@pytest.mark.parametrize("preset_path", PRESETS, ids=[p.stem for p in PRESETS])
@pytest.mark.parametrize("seed", [0, 42])
def test_build_triplets_equals_jax_for_each_preset(msmarco, preset_path, seed):
    preset = yaml.safe_load(preset_path.read_text())
    got = factory.build_triplets(msmarco, preset, seed=seed)
    want = jax_factory.build_triplets(msmarco, preset, seed=seed)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) > 0 and list(got.columns) == ["q_text", "d_pos_text", "d_neg_text"]


@pytest.mark.parametrize("preset,error", [
    ({"negative_sampler": {"type": "nope"}}, "unknown negative_sampler"),
    ({"positive_selector": "nope"}, "unknown positive_selector"),
])
def test_build_triplets_refuses_unknown_parts_as_jax_does(msmarco, preset, error):
    for pkg in (factory, jax_factory):
        with pytest.raises(ValueError, match=error):
            pkg.build_triplets(msmarco.head(5), preset)


def test_genealogy_sidecar_records_what_jax_records(tmp_path):
    preset = yaml.safe_load(PRESETS[0].read_text())
    records = {}
    for name, pkg in (("jax", jax_factory), ("torch", factory)):
        out = tmp_path / name / "triplets.parquet"
        out.parent.mkdir()
        out.write_bytes(b"0123456789")
        sidecar = pkg.write_genealogy(out, preset=preset, preset_path="p.yml", split="train",
                                      input_rows=10, output_rows=7, seed=3)
        assert sidecar == out.with_suffix(".parquet.genealogy.json")
        record = json.loads(sidecar.read_text())
        for step in record["pipeline"]:
            step.pop("timestamp")
            step.pop("file", None)
        records[name] = record
    assert records["torch"].pop("framework") == "twotowers_tpu_torch"
    assert records["jax"].pop("framework") == "twotowers_tpu"
    for record in records.values():
        record.pop("created")
    assert records["torch"] == records["jax"]
    assert records["torch"]["pipeline"][1]["bytes"] == 10


# ---- convert --------------------------------------------------------------------

def _pairs():
    return pd.DataFrame({"query": ["q1", "q1", "q1", "q2", "q3", "q3"],
                         "document": ["p1", "n1", "n2", "p2", "p3", "n3"],
                         "label": [1, 0, 0, 1, 1, 0]})


def _triplets(columns=("q_text", "d_pos_text", "d_neg_text")):
    q, p, n = columns
    return pd.DataFrame({q: ["q1", "q1", "q2"], p: ["p1", "p1", "p2"], n: ["n1", "n2", "n1"]})


@pytest.mark.parametrize("frame,target", [
    (_pairs(), "triplets"), (_pairs(), "pairs"),
    (_triplets(), "pairs"), (_triplets(), "triplets"),
    (_triplets(("query", "positive_doc", "negative_doc")), "pairs"),
])
def test_convert_dataset_format_equals_jax(frame, target):
    got = factory.convert_dataset_format(frame.copy(), target)
    want = jax_factory.convert_dataset_format(frame.copy(), target)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("frame,target,error", [
    (pd.DataFrame({"a": [1]}), "triplets", "Cannot convert"),
    (pd.DataFrame({"a": [1]}), "pairs", "Not a triplets frame"),
    (_pairs(), "csv", "unknown target format"),
])
def test_convert_refuses_as_jax_does(frame, target, error):
    for pkg in (factory, jax_factory):
        with pytest.raises(ValueError, match=error):
            pkg.convert_dataset_format(frame, target)


def test_convert_triplets_to_pairs_dedups_as_jax():
    got = factory.convert_triplets_to_pairs(_triplets())
    pd.testing.assert_frame_equal(got, jax_factory.convert_triplets_to_pairs(_triplets()))
    assert len(got) == 5


@pytest.mark.parametrize("source,header", [("pairs.tsv", True), ("pairs.tsv", False),
                                           ("triplets.tsv", True), ("pairs.parquet", True)])
@pytest.mark.parametrize("target,out_name", [("triplets", "out.parquet"),
                                             ("pairs", "out.tsv")])
def test_transform_and_save_writes_jax_files(data_dirs, source, header, target, out_name):
    frame = _triplets() if source.startswith("triplets") else _pairs()
    written = {}
    for name, pkg in (("jax", jax_factory), ("torch", factory)):
        raw = data_dirs[name] / "raw"
        raw.mkdir(parents=True)
        if source.endswith(".parquet"):
            frame.to_parquet(raw / source)
        else:
            frame.to_csv(raw / source, sep="\t", index=False, header=header)
        # relative paths resolve under data/raw and data/processed
        written[name] = pkg.transform_and_save_dataset(source, out_name, target)
        assert written[name] == data_dirs[name] / "processed" / out_name
    if out_name.endswith(".tsv"):
        assert written["torch"].read_bytes() == written["jax"].read_bytes()
    else:
        pd.testing.assert_frame_equal(pd.read_parquet(written["torch"]),
                                      pd.read_parquet(written["jax"]))


def test_transform_refuses_other_formats(tmp_path):
    for pkg in (factory, jax_factory):
        with pytest.raises(ValueError, match="Unsupported input format"):
            pkg.transform_and_save_dataset(tmp_path / "x.csv", tmp_path / "y.tsv", "pairs")


# ---- readers ----------------------------------------------------------------------

@pytest.mark.parametrize("header", [True, False])
def test_local_readers_equal_jax(tmp_path, header):
    tsv = tmp_path / "pairs.tsv"
    _pairs().to_csv(tsv, sep="\t", index=False, header=header)
    got = factory.load_synthetic_tsv(tsv)
    pd.testing.assert_frame_equal(got, jax_factory.load_synthetic_tsv(tsv))
    pd.testing.assert_frame_equal(readers.load_synthetic_dataset(tsv),
                                  jax_readers.load_synthetic_dataset(tsv))
    out = factory.convert_tsv_to_parquet(tsv, tmp_path / "torch" / "pairs.parquet")
    want = jax_factory.convert_tsv_to_parquet(tsv, tmp_path / "jax" / "pairs.parquet")
    pd.testing.assert_frame_equal(pd.read_parquet(out), pd.read_parquet(want))
    assert factory.convert_tsv_to_parquet(tsv) == tsv.with_suffix(".parquet")


def test_split_cache_round_trip(data_dirs, msmarco):
    head = msmarco.head(20)
    for name, pkg in (("jax", jax_factory), ("torch", factory)):
        pkg.setup_data_dirs()
        for sub in ("raw", "processed", "raw/parquet"):
            assert (data_dirs[name] / sub).is_dir()
        path = pkg.save_dataset_as_parquet(head, "validation")
        assert path == data_dirs[name] / "raw" / "parquet" / "ms_marco_v1.1_validation.parquet"
    got = factory.load_split("validation")
    want = jax_factory.load_split("validation")
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 20


class _StubSplit:
    def __init__(self, frame):
        self.frame = frame

    def to_pandas(self):
        return self.frame


def _stub_datasets(monkeypatch, frame, calls):
    def load_dataset(name, config):
        calls.append((name, config))
        return {"train": _StubSplit(frame), "validation": _StubSplit(frame.head(3))}

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))


def test_get_ms_marco_dataset_with_a_stub_datasets_module(data_dirs, msmarco, monkeypatch):
    calls = []
    _stub_datasets(monkeypatch, msmarco.head(10), calls)
    got = factory.get_ms_marco_dataset(splits=("train", "validation", "test"))
    want = jax_factory.get_ms_marco_dataset(splits=("train", "validation", "test"))
    assert calls == [("ms_marco", "v1.1")] * 2
    assert set(got) == set(want) == {"train", "validation"}
    for name in ("torch", "jax"):
        cached = sorted(p.name for p in (data_dirs[name] / "raw" / "parquet").iterdir())
        assert cached == ["ms_marco_v1.1_train.parquet", "ms_marco_v1.1_validation.parquet"]
    # a split not cached yet is fetched through the same call, then read back
    (data_dirs["torch"] / "raw" / "parquet" / "ms_marco_v1.1_train.parquet").unlink()
    pd.testing.assert_frame_equal(factory.load_split("train"), msmarco.head(10))
    assert len(calls) == 3


# ---- CLIs ------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--generate", "--num_pairs", "25", "--convert", "--seed", "4"],
    ["--generate", "--num_pairs", "10", "--negatives_per_query", "2", "--expand", "6",
     "--convert_parquet"],
])
def test_synthetic_dataset_gen_main_writes_jax_files(data_dirs, capsys, extra):
    outputs = {}
    for name, module in (("jax", jax_gen), ("torch", gen)):
        out = data_dirs[name] / "processed" / "triplets.parquet"
        assert module.main(extra + ["--output", str(out)]) == 0
        outputs[name] = (data_dirs[name] / "raw" / "pairs.tsv", out)
    printed = capsys.readouterr().out
    assert "Pairs TSV:" in printed
    assert outputs["torch"][0].read_bytes() == outputs["jax"][0].read_bytes()
    if "--convert" in extra:
        pd.testing.assert_frame_equal(pd.read_parquet(outputs["torch"][1]),
                                      pd.read_parquet(outputs["jax"][1]))
    if "--convert_parquet" in extra:
        got, want = (outputs[name][0].with_suffix(".parquet") for name in ("torch", "jax"))
        pd.testing.assert_frame_equal(pd.read_parquet(got), pd.read_parquet(want))


def test_synthetic_dataset_gen_main_needs_a_mode(data_dirs):
    with pytest.raises(SystemExit):
        gen.main([])


def test_build_dataset_main_writes_jax_triplets(data_dirs, tmp_path, capsys):
    preset = ROOT / "presets" / "intra_query_neg.yml"
    outs = {}
    for name, module in (("jax", jax_build), ("torch", build)):
        outs[name] = tmp_path / name / "out" / "triplets.parquet"
        assert module.main(["--preset", str(preset), "--input_parquet", str(FIXTURE),
                            "--output", str(outs[name]), "--seed", "5"]) == 0
    assert capsys.readouterr().out.count("triplets to") == 2
    pd.testing.assert_frame_equal(pd.read_parquet(outs["torch"]), pd.read_parquet(outs["jax"]))
    sidecar = json.loads(outs["torch"].with_suffix(".parquet.genealogy.json").read_text())
    assert sidecar["pipeline"][0]["rows"] == 1000 and sidecar["seed"] == 5
