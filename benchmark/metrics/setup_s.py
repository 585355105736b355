"""Seconds from the start of the process to the window's first call."""


def read(record):
    return record["setup_s"]
