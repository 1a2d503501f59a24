from .diagnostics import (assert_finite, check_matrix_input, checked, cholesky_health,
                          finite_or_debug)
from .profiling import Timer, profile, trace_annotation
from .summary import parameter_table, print_summary, summary_string

__all__ = ["Timer", "trace_annotation", "profile",
           "assert_finite", "cholesky_health", "finite_or_debug",
           "parameter_table", "print_summary", "summary_string",
           "checked", "check_matrix_input"]
