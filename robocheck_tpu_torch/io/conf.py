"""Configuration-file IO.

Text format of the reference datasets (`Utils_rai.cu:11-109`):

    There are <V> valid configurations and <I> invalid configurations
    x y z pitch yaw roll valid
    ...

``valid`` is 0/1; True means collision-free. Readers tolerate a missing tag
column (untagged files). This NumPy reader is the format reference.

Header counts are parsed separately from the row tags because the two can
disagree: the reference's own ``10,000samples.conf`` claims "7296 valid /
2704 invalid" in its header while every row tag is 0 — the header records an
FCL run whose verdicts were never written back to the rows. ``tags_match_header``
detects this; consumers should treat such files as untagged rows + a trusted
aggregate count (this framework reproduces the 7296 exactly, see
tests/test_pipeline_golden.py).
"""
from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np

_HEADER_RE = re.compile(
    r"there are\s+(\d+)\s+valid configurations and\s+(\d+)\s+invalid",
    re.IGNORECASE,
)


class TaggedConfs(NamedTuple):
    confs: np.ndarray  # [N, 6] float32: x y z pitch yaw roll
    valid: np.ndarray | None  # [N] bool, or None if the file was untagged
    header_valid: int | None = None  # header's claimed valid count
    header_invalid: int | None = None  # header's claimed invalid count

    @property
    def num_valid(self) -> int:
        return 0 if self.valid is None else int(self.valid.sum())

    @property
    def tags_match_header(self) -> bool | None:
        """None if either side is absent; else whether the row tags add up
        to the header's claimed counts (both the valid count and, when the
        header supplies one, the invalid count — so a truncated or padded
        file with a coincidentally right valid count is still flagged)."""
        if self.valid is None or self.header_valid is None:
            return None
        if self.num_valid != self.header_valid:
            return False
        if self.header_invalid is not None:
            return len(self.valid) - self.num_valid == self.header_invalid
        return True


def read_conf_file(path: str | os.PathLike) -> TaggedConfs:
    with open(path, "r") as f:
        first = f.readline()
        # Header line is free text with counts; data rows are 6 or 7 numbers.
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    hv = hi = None
    if not first.lower().startswith("there are"):
        # No header — re-parse including the first line.
        rows = [list(map(float, first.split()))] if first.strip() else []
        body = data.tolist() if data.size else []
        data = np.asarray(rows + body, dtype=np.float64)
    else:
        m = _HEADER_RE.search(first)
        if m:
            hv, hi = int(m.group(1)), int(m.group(2))

    if data.size == 0:
        return TaggedConfs(
            np.zeros((0, 6), np.float32), np.zeros((0,), bool), hv, hi
        )
    if data.shape[1] == 7:
        return TaggedConfs(
            data[:, :6].astype(np.float32), data[:, 6].astype(bool), hv, hi
        )
    if data.shape[1] == 6:
        return TaggedConfs(data.astype(np.float32), None, hv, hi)
    raise ValueError(f"unexpected column count {data.shape[1]} in {path}")


def write_conf_file(
    path: str | os.PathLike, confs: np.ndarray, valid: np.ndarray | None = None
) -> None:
    """Write a (tagged) configuration file in the reference format
    (`Utils_rai.cu:11-41`: header with valid/invalid counts, %g-style floats).
    """
    confs = np.asarray(confs)
    n = confs.shape[0]
    if valid is None:
        valid = np.zeros((n,), dtype=bool)
    nv = int(np.asarray(valid).sum())
    with open(path, "w") as f:
        f.write(
            f"There are {nv} valid configurations and {n - nv} invalid configurations\n"
        )
        for i in range(n):
            row = " ".join(f"{float(v):g}" for v in confs[i, :6])
            f.write(f"{row} {int(valid[i])}\n")
