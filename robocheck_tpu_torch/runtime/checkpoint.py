"""Checkpoint / resume of long-running optimizer state (a numpy copy of
`robocheck_tpu.runtime.checkpoint`, same file layout, so a checkpoint
written by either package loads in the other).

Plain ``.npz`` + a ``.meta.json`` sidecar; no framework dependency. Atomic
via write-to-temp + rename.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def save(path, arrays: dict[str, np.ndarray], meta: dict | None = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    # np.savez appends .npz to names without it.
    produced = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    os.replace(produced, path)
    if meta is not None:
        mtmp = path.with_suffix(".meta.tmp")
        mtmp.write_text(json.dumps(meta, indent=2))
        os.replace(mtmp, path.with_suffix(".meta.json"))


def load(path) -> tuple[dict[str, np.ndarray], dict | None]:
    path = Path(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta_path = path.with_suffix(".meta.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else None
    return arrays, meta


def exists(path) -> bool:
    return Path(path).exists()
