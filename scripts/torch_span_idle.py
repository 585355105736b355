"""Where a benchmark cell's device idle time falls among the program's spans,
on one CUDA card, and what the spans cost.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_span_idle.py --workload <name> [--seed N] [--turns 2]
        [--seconds 2]

Sets the cell up as `benchmark/run.py` does (its driver and its pool from
``--seed``), then takes traced slices of ``--seconds`` each, as the
benchmark's traced run takes its slice, in turns: spans on, off, off, on,
``--turns`` times. "Off" replaces the program's `span` by the no-op
context, as a program without spans runs. Each slice prints one JSON line:
its ms per call and device idle ms per call; with spans on also the idle ms
per call charged to the innermost `rc.` span open (or outside the program;
`benchmark/harness/spans.idle_by_span`), their sum against the idle time,
and the idle metrics' readings. First it prints the cost of one `span` with
no profiler running, in µs. Every line carries the card's name and power
limit. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import timeit
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]

from harness import cli, spans, spec, trace  # noqa: E402

GROUPS = {"io": spans.CHECK_IO, "resolve": spans.CHECK_RESOLVE, "launch": spans.CHECK_LAUNCH,
          "bounds": spans.CLEARANCE_BOUNDS, "exact": spans.CLEARANCE_EXACT,
          "pairs": ("rc.chunked.pairs",), "chunked_resolve": ("rc.chunked.resolve",)}


def off_cost_us(n: int = 200_000) -> dict:
    """Best of 5 timings of ``n`` entries, µs each: the gated span with no
    profiler running, the shared no-op it returns, and an ungated
    ``record_function``."""
    import torch

    from robocheck_tpu_torch.profiling import timers

    def gated():
        with timers.span("rc.cost"):
            pass

    def noop():
        with timers._OFF:
            pass

    def ungated():
        with torch.profiler.record_function("rc.cost"):
            pass

    return {name: min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6
            for name, fn in (("gated_span", gated), ("no_op", noop),
                             ("record_function", ungated))}


def set_spans(on: bool) -> None:
    """Spans as the program has them, or the no-op in their place."""
    from robocheck_tpu_torch.kernels import chunked, megakernel
    from robocheck_tpu_torch.planner import clearance
    from robocheck_tpu_torch.profiling import timers

    def off(name):
        return timers._OFF

    megakernel.span = clearance.span = chunked.span = timers.span if on else off


def one_slice(session, seconds: float, on: bool) -> dict:
    set_spans(on)
    calls, failed = cli.Calls(), []
    sl, (lo, hi) = cli._traced_slice(session, "cuda", seconds, calls, failed)
    set_spans(True)
    n = hi - lo
    span_us = sl["hi"] - sl["lo"]
    idle_us = span_us - trace.busy_us(sl["device"])
    out = {"spans": "on" if on else "off", "calls": n, "failed": len(failed),
           "ms_per_call": span_us / 1e3 / n, "idle_ms_per_call": idle_us / 1e3 / n}
    if on:
        by = spans.idle_by_span(sl)
        out["idle_ms_per_call_by_span"] = {k: v / 1e3 / n for k, v in
                                           sorted(by.items(), key=lambda kv: -kv[1])}
        out["charged_over_idle"] = sum(by.values()) / idle_us
        record = {"slice": {"trace": sl, "calls": n, "batches": calls.batch[lo:hi]}}
        out["idle_ms_per_call_under"] = {k: spans.idle_ms_per_call(record, names)
                                         for k, names in GROUPS.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=cli.TRACE_SECONDS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_span_idle: no CUDA device")
    cli._set_env()
    card = cli._card_line()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "span_off_cost_us": off_cost_us()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    session = cell.driver().Session(cli.Context(cell, args.seed, "cuda", None))
    torch.cuda.synchronize()
    ms = {"on": [], "off": []}
    for _ in range(args.turns):
        for on in (True, False, False, True):
            line = one_slice(session, args.seconds, on)
            ms[line["spans"]].append(line["ms_per_call"])
            print(json.dumps({"card": card, "workload": args.workload, **line}), flush=True)
    session.close()
    print(json.dumps({"card": card, "workload": args.workload, "ms_per_call": ms,
                      "median_on_over_off": statistics.median(ms["on"])
                      / statistics.median(ms["off"])}))


if __name__ == "__main__":
    main()
