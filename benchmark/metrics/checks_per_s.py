"""Configurations checked a second: every row of every call completed in the
window, over the window's seconds (host clock)."""
from harness.readers import units_per_s as read  # noqa: F401
