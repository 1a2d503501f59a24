from .diagnostics import check_matrix_input

__all__ = ["check_matrix_input"]
