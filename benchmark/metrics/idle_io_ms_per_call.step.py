"""Device idle ms per planner step in the traced slice while the program is in
its host in/out steps: the spans `rc.check.validate`, `rc.check.upload` and
`rc.check.fetch`, with what they hold."""
from harness.spans import CHECK_IO, idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, CHECK_IO)
