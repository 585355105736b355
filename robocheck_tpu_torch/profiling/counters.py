"""Pipeline observability counters.

A copy of `robocheck_tpu.profiling.counters` (numpy only; the port imports
nothing of the JAX package). The reference narrates every step with prints
and a valid-count summary (`full-integration-test.cu:465-473`, the FP/FN
triage at `:695-724`); this module structures the same signals: throughput,
cull rates at each level of the work-elimination hierarchy, and verdict-diff
triage.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CheckStats:
    num_confs: int
    num_valid: int
    num_colliding: int
    broad_culled: int  # level-0: skipped by mesh AABB
    coplanar_flagged: int
    mean_pairs_surviving: float  # level-2 survivors among broad hits
    elapsed_s: float

    @property
    def checks_per_s(self) -> float:
        return self.num_confs / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def broad_cull_rate(self) -> float:
        return self.broad_culled / max(self.num_confs, 1)

    @staticmethod
    def from_check(valid, coplanar, num_pairs, broad_hit, elapsed_s):
        valid = np.asarray(valid)
        broad_hit = np.asarray(broad_hit)
        bh = broad_hit.sum()
        return CheckStats(
            num_confs=len(valid),
            num_valid=int(valid.sum()),
            num_colliding=int((~valid).sum()),
            broad_culled=int(len(valid) - bh),
            coplanar_flagged=int(np.asarray(coplanar).sum()),
            mean_pairs_surviving=float(
                np.asarray(num_pairs)[broad_hit].mean() if bh else 0.0
            ),
            elapsed_s=elapsed_s,
        )

    def report(self) -> str:
        return (
            f"{self.num_confs} confs in {self.elapsed_s:.3f}s "
            f"({self.checks_per_s:,.0f}/s): {self.num_valid} valid, "
            f"{self.num_colliding} colliding; broad cull "
            f"{self.broad_cull_rate:.1%}; mean surviving pairs "
            f"{self.mean_pairs_surviving:.1f}; coplanar flags "
            f"{self.coplanar_flagged}"
        )


def verdict_diff(predicted: np.ndarray, golden: np.ndarray) -> dict:
    """The reference's FP/FN triage (`full-integration-test.cu:695-724`):
    false_positive = predicted valid but actually colliding."""
    predicted = np.asarray(predicted, dtype=bool)
    golden = np.asarray(golden, dtype=bool)
    fp = predicted & ~golden
    fn = ~predicted & golden
    return {
        "n": len(predicted),
        "mismatches": int((predicted != golden).sum()),
        "false_positives": int(fp.sum()),
        "false_negatives": int(fn.sum()),
        "fp_indices": np.nonzero(fp)[0][:32].tolist(),
        "fn_indices": np.nonzero(fn)[0][:32].tolist(),
    }
