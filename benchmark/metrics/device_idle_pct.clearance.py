"""100 - the share of the traced slice that the device spends in kernels,
copies and fills (the union of their records), in %."""
from harness.readers import device_idle_pct as read  # noqa: F401
