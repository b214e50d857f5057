"""Report generation: offline markdown + optional hosted W&B reports."""

from .compare_report import create_comparison_report
from .single_report import create_run_report

__all__ = ["create_comparison_report", "create_run_report"]
