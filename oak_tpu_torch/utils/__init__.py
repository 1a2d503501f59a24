from .diagnostics import check_matrix_input
from .summary import parameter_table, print_summary, summary_string

__all__ = ["check_matrix_input", "parameter_table", "print_summary", "summary_string"]
