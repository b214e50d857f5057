"""Hub tooling CLI: repos, cards, project bootstrap, migration helper.

The counterpart of ``twotowers_tpu/hub/cli.py``. The repo and upload
subcommands import ``huggingface_hub`` inside the call; ``model-card``,
``dataset-card`` and ``migrate`` work offline. ``migrate`` rewrites imports
of the original PyTorch package layout (``twotower.*``, ``dataset_factory``)
to this package's modules.

Usage:
    python -m twotowers_tpu_torch.hub.cli create-repo --repo-id user/name [--dataset]
    python -m twotowers_tpu_torch.hub.cli upload --repo-id user/name --path dir/
    python -m twotowers_tpu_torch.hub.cli download --repo-id user/name
    python -m twotowers_tpu_torch.hub.cli setup-project --name myproj --user me
    python -m twotowers_tpu_torch.hub.cli model-card --repo-id x --output README.md
    python -m twotowers_tpu_torch.hub.cli migrate --path src/ [--apply]
"""

from __future__ import annotations

import argparse
import os
import re
from pathlib import Path

from ..utils.logging import get_logger, setup_logging
from .huggingface import _api, _model_card

logger = get_logger("hub.cli")

# original-layout import -> this package (used by `migrate`)
IMPORT_REWRITES = [
    (re.compile(r"\bfrom twotower\.tokenisers\b"), "from twotowers_tpu_torch.tokenizers"),
    (re.compile(r"\bfrom twotower\.embeddings\b"), "from twotowers_tpu_torch.models.embeddings"),
    (re.compile(r"\bfrom twotower\.encoders\b"), "from twotowers_tpu_torch.models.towers"),
    (re.compile(r"\bfrom twotower\.losses\b"), "from twotowers_tpu_torch.models.losses"),
    (re.compile(r"\bfrom twotower\.dataset\b"), "from twotowers_tpu_torch.data.triplets"),
    (re.compile(r"\bfrom twotower\.train\b"), "from twotowers_tpu_torch.train"),
    (re.compile(r"\bfrom twotower\.evaluate\b"), "from twotowers_tpu_torch.evaluation"),
    (re.compile(r"\bfrom twotower\.utils\b"), "from twotowers_tpu_torch.utils"),
    (re.compile(r"\bfrom twotower\.huggingface\b"), "from twotowers_tpu_torch.hub.huggingface"),
    (re.compile(r"\bfrom dataset_factory\b"), "from twotowers_tpu_torch.data.factory"),
    (re.compile(r"\bimport twotower\b"), "import twotowers_tpu_torch"),
    (re.compile(r"\bimport dataset_factory\b"),
     "import twotowers_tpu_torch.data.factory as dataset_factory"),
]


def _dataset_card(repo_id: str) -> str:
    return (
        "---\n"
        "tags: [retrieval, triplets, ms-marco]\n"
        "---\n\n"
        f"# {repo_id}\n\n"
        "Triplet training data (`q_text`, `d_pos_text`, `d_neg_text` parquet)\n"
        "built with the `twotowers_tpu_torch` dataset factory. See the\n"
        "`.genealogy.json` sidecars for full provenance.\n"
    )


def cmd_create_repo(args) -> int:
    api = _api(args.token)
    repo_type = "dataset" if args.dataset else "model"
    api.create_repo(args.repo_id, private=args.private, exist_ok=True,
                    repo_type=repo_type)
    print(f"Created {repo_type} repo https://huggingface.co/{args.repo_id}")
    return 0


def cmd_upload(args) -> int:
    api = _api(args.token)
    repo_type = "dataset" if args.dataset else "model"
    api.upload_folder(folder_path=args.path, repo_id=args.repo_id,
                      repo_type=repo_type)
    print(f"Uploaded {args.path} -> {args.repo_id}")
    return 0


def cmd_download(args) -> int:
    from huggingface_hub import snapshot_download

    local = snapshot_download(
        args.repo_id, repo_type="dataset" if args.dataset else "model",
        token=args.token or os.environ.get("HUGGINGFACE_ACCESS_TOKEN"),
    )
    print(local)
    return 0


def cmd_setup_project(args) -> int:
    """Bootstrap model + dataset repos with cards."""
    api = _api(args.token)
    model_repo = f"{args.user}/{args.name}"
    data_repo = f"{args.user}/{args.name}-data"
    api.create_repo(model_repo, exist_ok=True, private=args.private)
    api.create_repo(data_repo, exist_ok=True, private=args.private,
                    repo_type="dataset")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        card = Path(tmp) / "README.md"
        card.write_text(_model_card(model_repo, None))
        api.upload_file(path_or_fileobj=str(card), path_in_repo="README.md",
                        repo_id=model_repo)
        card.write_text(_dataset_card(data_repo))
        api.upload_file(path_or_fileobj=str(card), path_in_repo="README.md",
                        repo_id=data_repo, repo_type="dataset")
    print(f"Project ready: {model_repo} + {data_repo}")
    return 0


def cmd_model_card(args) -> int:
    card = _model_card(args.repo_id, None)
    if args.output:
        Path(args.output).write_text(card)
        print(args.output)
    else:
        print(card)
    return 0


def cmd_dataset_card(args) -> int:
    card = _dataset_card(args.repo_id)
    if args.output:
        Path(args.output).write_text(card)
        print(args.output)
    else:
        print(card)
    return 0


def cmd_migrate(args) -> int:
    """Rewrite original-layout imports to twotowers_tpu_torch (lint or apply)."""
    root = Path(args.path)
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    total = 0
    for file in files:
        text = file.read_text()
        updated = text
        hits = []
        for pattern, replacement in IMPORT_REWRITES:
            updated, n = pattern.subn(replacement, updated)
            if n:
                hits.append((pattern.pattern, replacement, n))
        if hits:
            total += sum(n for _, _, n in hits)
            print(f"{file}:")
            for pat, rep, n in hits:
                print(f"  {n}x {pat} -> {rep}")
            if args.apply:
                file.write_text(updated)
    print(f"{'Rewrote' if args.apply else 'Found'} {total} import(s)"
          + ("" if args.apply else " (use --apply to rewrite)"))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Hub tooling")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, needs_repo=True):
        if needs_repo:
            p.add_argument("--repo-id", required=True)
        p.add_argument("--token", default=None)
        p.add_argument("--private", action="store_true")
        p.add_argument("--dataset", action="store_true")

    p = sub.add_parser("create-repo"); common(p); p.set_defaults(fn=cmd_create_repo)
    p = sub.add_parser("upload"); common(p)
    p.add_argument("--path", required=True); p.set_defaults(fn=cmd_upload)
    p = sub.add_parser("download"); common(p); p.set_defaults(fn=cmd_download)
    p = sub.add_parser("setup-project")
    p.add_argument("--name", required=True); p.add_argument("--user", required=True)
    p.add_argument("--token", default=None); p.add_argument("--private", action="store_true")
    p.set_defaults(fn=cmd_setup_project)
    p = sub.add_parser("model-card"); common(p)
    p.add_argument("--output", default=None); p.set_defaults(fn=cmd_model_card)
    p = sub.add_parser("dataset-card"); common(p)
    p.add_argument("--output", default=None); p.set_defaults(fn=cmd_dataset_card)
    p = sub.add_parser("migrate")
    p.add_argument("--path", required=True); p.add_argument("--apply", action="store_true")
    p.set_defaults(fn=cmd_migrate)

    args = parser.parse_args(argv)
    setup_logging(log_level="WARNING")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
