"""Rows the float64 resolution takes per call (valid, bit 1 or 2 set), from
one `check_packed` call on each batch after the window."""
from harness.readers import resolve_rows_per_call as read  # noqa: F401
