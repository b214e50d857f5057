"""The port's Hub package (``twotowers_tpu_torch.hub``) against the JAX
package's, offline.

``huggingface_hub`` is replaced in ``sys.modules`` by a stub that records
every call (``HfApi`` and ``snapshot_download``), so the upload, load and
dataset download run their whole local half with nothing sent. Each
function and CLI subcommand of the port makes the calls the JAX package's
makes on the same stub, and stages the same files; the model card differs
only where it names the package, PyTorch and CUDA. ``huggingface.push_to_hub``
goes through the port's ``train_model`` on the CPU: the best model is
staged and uploaded, and an upload that fails is logged while training
still returns. ``migrate`` rewrites to modules of the port, each importable
without JAX.
"""

import json
import logging
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import twotowers_tpu.hub.cli as jax_cli
import twotowers_tpu.hub.huggingface as jax_hf
import twotowers_tpu_torch.hub.cli as cli
import twotowers_tpu_torch.hub.huggingface as hf
from test_torch_loop import _config, _word_tsv
from twotowers_tpu_torch.hub import (
    download_dataset_from_hub, load_model_from_hub, save_and_upload, save_model_for_hub,
    upload_model_to_hub)
from twotowers_tpu_torch.train import load_trained_model, train_model

ROOT = Path(__file__).resolve().parents[1]
CARD_SWAPS = [("jax, tpu]", "pytorch, cuda]"),
              ("library_name: twotowers_tpu\n", "library_name: twotowers_tpu_torch\n"),
              ("TPU-native two-tower retrieval model trained with `twotowers_tpu`.",
               "Two-tower retrieval model trained with `twotowers_tpu_torch` (PyTorch, CUDA)."),
              ("`twotowers_tpu.hub.", "`twotowers_tpu_torch.hub."),
              ("`twotowers_tpu` dataset factory", "`twotowers_tpu_torch` dataset factory")]


def _as_port(text):
    for old, new in CARD_SWAPS:
        text = text.replace(old, new)
    return text


class _Hub:
    """A stub ``huggingface_hub``: records calls, downloads into ``root``."""

    def __init__(self, root, fail_upload=False, user="someone"):
        self.calls, self.root, self.fail_upload, self.user = [], Path(root), fail_upload, user
        hub = self

        class HfApi:
            def __init__(self, token=None):
                hub.calls.append(("HfApi", token))

            def whoami(self):
                if hub.user is None:
                    raise RuntimeError("no token")
                return {"name": hub.user}

            def create_repo(self, repo_id, **kwargs):
                hub.calls.append(("create_repo", repo_id, sorted(kwargs.items())))

            def upload_folder(self, folder_path, repo_id, **kwargs):
                if hub.fail_upload:
                    raise ConnectionError("the Hub is unreachable")
                files = sorted(p.relative_to(folder_path).as_posix()
                               for p in Path(folder_path).rglob("*") if p.is_file())
                hub.calls.append(("upload_folder", repo_id, files, sorted(kwargs.items())))

            def upload_file(self, path_or_fileobj, path_in_repo, repo_id, **kwargs):
                hub.calls.append(("upload_file", path_in_repo, repo_id,
                                  Path(path_or_fileobj).read_text(), sorted(kwargs.items())))

        def snapshot_download(repo_id, **kwargs):
            hub.calls.append(("snapshot_download", repo_id,
                              sorted((k, v) for k, v in kwargs.items() if k != "cache_dir")))
            return str(hub.root / repo_id.replace("/", "--"))

        self.module = types.ModuleType("huggingface_hub")
        self.module.HfApi = HfApi
        self.module.snapshot_download = snapshot_download


@pytest.fixture
def stub_hub(monkeypatch, tmp_path):
    def make(**kwargs):
        hub = _Hub(tmp_path / "hub_cache", **kwargs)
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
        return hub
    monkeypatch.delenv(hf.TOKEN_ENV, raising=False)
    return make


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint directory the port's train_model wrote (word vocab, CPU)."""
    tmp_path = tmp_path_factory.mktemp("trained")
    data, rows = _word_tsv(tmp_path / "train.tsv", np.random.default_rng(0), n=40)
    config = _config(tmp_path, data, epochs=1)
    train_model(config, seed=0, device="cpu")
    return tmp_path, config, rows


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in Path(root).rglob("*") if p.is_file()}


@pytest.mark.parametrize("repo_id", ["someone/two-tower", "two-tower"])
def test_staged_layout_and_model_card_match_jax(trained, tmp_path, repo_id):
    ckpt_dir, config, _ = trained
    best = ckpt_dir / "ckpt" / "best_model"
    got = Path(save_model_for_hub(str(best), str(tmp_path / "port"), repo_id=repo_id))
    want = Path(jax_hf.save_model_for_hub(str(best), str(tmp_path / "jax"), repo_id=repo_id))
    port, jax_files = _files(got), _files(want)
    assert set(port) == set(jax_files) == {"README.md", "checkpoint/params.npz",
                                          "checkpoint/opt_state.npz", "checkpoint/meta.json"}
    assert all(port[k] == jax_files[k] for k in port if k != "README.md")
    card = port["README.md"].decode()
    assert card == _as_port(jax_files["README.md"].decode()) != jax_files["README.md"].decode()
    assert f"# {repo_id}" in card and "- hidden dim: `32`" in card
    assert "jax" not in card.lower() and "tpu" not in card.replace("twotowers_tpu_torch", "")
    # staging again replaces the folder; the staged checkpoint loads
    save_model_for_hub(str(best), str(got), repo_id=repo_id)
    assert _files(got) == port
    model, spec, _, _ = load_trained_model(str(got / "checkpoint"), device="cpu")
    assert spec.tower.hidden_dim == config["encoder"]["hidden_dim"]


def _both(stub_hub, call):
    """``call(module)`` on the port's and on JAX's functions, each against a
    fresh stub: (port result, its calls, JAX result, its calls)."""
    out = []
    for module in (hf, jax_hf):
        hub = stub_hub()
        out += [call(module), hub.calls]
    return out


def test_upload_load_and_dataset_download_match_jax(stub_hub, trained, tmp_path, monkeypatch):
    ckpt_dir, _, _ = trained
    staged = save_model_for_hub(str(ckpt_dir / "ckpt" / "best_model"), str(tmp_path / "s"))
    got, calls, want, jax_calls = _both(stub_hub, lambda m: m.upload_model_to_hub(
        staged, "someone/two-tower", private=True, token="t0"))
    assert got == want == "https://huggingface.co/someone/two-tower" and calls == jax_calls
    assert calls == [("HfApi", "t0"),
                     ("create_repo", "someone/two-tower", [("exist_ok", True), ("private", True)]),
                     ("upload_folder", "someone/two-tower",
                      ["README.md", "checkpoint/meta.json", "checkpoint/opt_state.npz",
                       "checkpoint/params.npz"], [])]

    monkeypatch.setenv(hf.TOKEN_ENV, "env-token")
    got, calls, want, jax_calls = _both(stub_hub, lambda m: m.load_model_from_hub("someone/m"))
    assert got == want == str(tmp_path / "hub_cache" / "someone--m" / "checkpoint")
    assert calls == jax_calls == [("snapshot_download", "someone/m", [("token", "env-token")])]
    got, calls, want, jax_calls = _both(stub_hub, lambda m: m.download_dataset_from_hub(
        "someone/d", token="t1"))
    assert got == want and calls == jax_calls == [
        ("snapshot_download", "someone/d", [("repo_type", "dataset"), ("token", "t1")])]


@pytest.mark.parametrize("user", ["someone", None])
def test_save_and_upload_resolves_the_user_as_jax_does(stub_hub, trained, tmp_path, user):
    ckpt_dir, _, _ = trained
    best = str(ckpt_dir / "ckpt" / "best_model")
    results = []
    for module, out in ((hf, "port"), (jax_hf, "jax")):
        hub = stub_hub(user=user)
        url = module.save_and_upload(best, "two-tower", local_dir=str(tmp_path / out))
        results.append((url, hub.calls))
    assert results[0] == results[1]
    repo = "someone/two-tower" if user else "two-tower"
    assert results[0][0] == f"https://huggingface.co/{repo}"
    assert ("create_repo", repo, [("exist_ok", True), ("private", False)]) in results[0][1]


def test_without_huggingface_hub_each_call_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for call in (lambda: upload_model_to_hub(str(tmp_path), "a/b"),
                 lambda: load_model_from_hub("a/b"),
                 lambda: download_dataset_from_hub("a/b"),
                 lambda: save_and_upload(str(tmp_path), "a/b")):
        with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
            call()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("fail_upload", [False, True])
def test_push_to_hub_through_train_model(stub_hub, tmp_path, fail_upload):
    """``huggingface.push_to_hub`` stages best_model beside the checkpoints
    and uploads it; an upload that fails is logged and training returns."""
    hub = stub_hub(fail_upload=fail_upload)
    data, _ = _word_tsv(tmp_path / "train.tsv", np.random.default_rng(1), n=40)
    config = _config(tmp_path, data, epochs=2,
                     huggingface={"push_to_hub": True, "repo_id": "someone/pushed"})
    records = _Records()
    logger = logging.getLogger("twotowers_tpu_torch.train.loop")
    logger.addHandler(records)
    try:
        state, _ = train_model(config, seed=0, device="cpu")
    finally:
        logger.removeHandler(records)
    assert state.step == 2 * 3
    staged = tmp_path / "ckpt" / "hub_export"
    assert sorted(_files(staged)) == ["README.md", "checkpoint/meta.json",
                                      "checkpoint/opt_state.npz", "checkpoint/params.npz"]
    assert (staged / "checkpoint" / "meta.json").read_bytes() == (
        tmp_path / "ckpt" / "best_model" / "meta.json").read_bytes()
    uploads = [c for c in hub.calls if c[0] == "upload_folder"]
    if fail_upload:
        assert not uploads and records.messages == [
            "Failed to push model to the Hub: the Hub is unreachable"]
    else:
        assert [c[1] for c in uploads] == ["someone/pushed"] and not records.messages


def _cli_out(capsys, module, argv):
    code = module.main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["create-repo", "--repo-id", "u/m", "--token", "t", "--private"],
    ["create-repo", "--repo-id", "u/d", "--dataset"],
    ["upload", "--repo-id", "u/m", "--path", "STAGED"],
    ["upload", "--repo-id", "u/d", "--path", "STAGED", "--dataset"],
    ["download", "--repo-id", "u/m", "--token", "t"],
    ["download", "--repo-id", "u/d", "--dataset"],
    ["setup-project", "--name", "proj", "--user", "u"],
    ["model-card", "--repo-id", "u/m"],
    ["model-card", "--repo-id", "u/m", "--output", "OUT"],
    ["dataset-card", "--repo-id", "u/d"],
    ["dataset-card", "--repo-id", "u/d", "--output", "OUT"],
])
def test_cli_subcommands_match_jax(stub_hub, capsys, tmp_path, argv):
    staged = tmp_path / "staged"
    (staged / "checkpoint").mkdir(parents=True)
    (staged / "README.md").write_text("card")
    (staged / "checkpoint" / "meta.json").write_text("{}")
    results = []
    for module, name in ((cli, "port"), (jax_cli, "jax")):
        hub = stub_hub()
        out_file = tmp_path / f"{name}.md"
        args = [str(staged) if a == "STAGED" else str(out_file) if a == "OUT" else a
                for a in argv]
        code, out = _cli_out(capsys, module, args)
        written = out_file.read_text() if out_file.exists() else None
        results.append((code, out.replace(str(out_file), "OUT"), written, hub.calls))
    (code, out, written, calls), (jax_code, jax_out, jax_written, jax_calls) = results
    assert code == jax_code == 0
    assert out == _as_port(jax_out)
    assert written == (None if jax_written is None else _as_port(jax_written))
    assert [(c[0], c[1], c[2], _as_port(c[3]), *c[4:]) if c[0] == "upload_file" else c
            for c in jax_calls] == calls


_ORIGINAL = ("from twotower.encoders import build_two_tower\n"
             "from twotower.evaluate import evaluate_model\n"
             "from twotower.tokenisers import CharTokenizer\n"
             "import dataset_factory\n"
             "import twotower\n")


@pytest.mark.parametrize("apply", [False, True])
def test_migrate_lint_and_apply(capsys, tmp_path, apply):
    src = tmp_path / "pkg" / "code.py"
    src.parent.mkdir()
    src.write_text(_ORIGINAL)

    class Args:
        path = str(tmp_path / "pkg")

    Args.apply = apply
    assert cli.cmd_migrate(Args()) == 0
    out = capsys.readouterr().out
    if not apply:
        assert src.read_text() == _ORIGINAL and "Found 5 import(s)" in out
        return
    text = src.read_text()
    assert "Rewrote 5 import(s)" in out and "twotower." not in text.replace(
        "twotowers_tpu_torch.", "")
    assert text == ("from twotowers_tpu_torch.models.towers import build_two_tower\n"
                    "from twotowers_tpu_torch.evaluation import evaluate_model\n"
                    "from twotowers_tpu_torch.tokenizers import CharTokenizer\n"
                    "import twotowers_tpu_torch.data.factory as dataset_factory\n"
                    "import twotowers_tpu_torch\n")
    # the same rewrites as JAX's table, into the port
    assert [(p.pattern, _as_port_module(r)) for p, r in jax_cli.IMPORT_REWRITES] == [
        (p.pattern, r) for p, r in cli.IMPORT_REWRITES]


def _as_port_module(replacement):
    return replacement.replace("twotowers_tpu", "twotowers_tpu_torch")


_IMPORT_TARGETS = """
import importlib, json, sys
for blocked in ("jax", "jaxlib", "twotowers_tpu"):
    sys.modules[blocked] = None
for module in json.loads(sys.argv[1]):
    importlib.import_module(module)
print("ok")
"""


def test_every_rewrite_target_is_a_module_of_the_port_importable_without_jax():
    targets = sorted({r.replace("from ", "").replace("import ", "").split(" as ")[0].strip()
                      for _, r in cli.IMPORT_REWRITES})
    assert targets and all(t.split(".")[0] == "twotowers_tpu_torch" for t in targets)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", _IMPORT_TARGETS, json.dumps(targets)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split() == ["ok"], out.stderr[-3000:]
