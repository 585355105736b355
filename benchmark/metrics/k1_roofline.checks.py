"""K1's least time per call over its device time per call in the traced
slice, in % (`harness/work.py` counts the least work)."""
from harness.readers import k1_roofline as read  # noqa: F401
