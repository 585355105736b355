"""Clearance queries answered a second: every query of every call completed
in the window, over the window's seconds (host clock)."""
from harness.readers import units_per_s as read  # noqa: F401
