"""Reports CLI: single-run and comparison reports.

The counterpart of ``twotowers_tpu/reports/cli.py`` and the root
``create_report.py``.

Usage:
    python -m twotowers_tpu_torch.reports.cli single --run logs/<run_dir>
    python -m twotowers_tpu_torch.reports.cli compare --runs logs/a logs/b
    python -m twotowers_tpu_torch.reports.cli single --run <dir> --wandb --project p
"""

from __future__ import annotations

import argparse

from .compare_report import create_comparison_report
from .single_report import create_run_report, create_wandb_report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Generate training reports")
    sub = parser.add_subparsers(dest="command", required=True)

    single = sub.add_parser("single", help="Report for one run")
    single.add_argument("--run", required=True, help="Run log directory")
    single.add_argument("--output", default=None)
    single.add_argument("--wandb", action="store_true",
                        help="Publish a hosted W&B report instead of markdown")
    single.add_argument("--project", default="two-tower-retrieval")
    single.add_argument("--entity", default=None)

    compare = sub.add_parser("compare", help="Compare multiple runs")
    compare.add_argument("--runs", nargs="+", required=True)
    compare.add_argument("--output", default=None)

    args = parser.parse_args(argv)
    if args.command == "single":
        if args.wandb:
            url = create_wandb_report(args.run, args.project, args.entity)
            print(f"W&B report: {url}")
        else:
            print(create_run_report(args.run, args.output))
    else:
        print(create_comparison_report(args.runs, args.output))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
