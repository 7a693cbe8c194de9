"""Run a cell traced with the port's spans recorded, and read them.

    python3 benchmark/spans.py --workload ml10m_r32.chain --seed 1 \\
        --seconds 40
    python3 benchmark/spans.py --workload ml10m_r32.chain --seed 1 \\
        --seconds 15 --overhead 6

The first form runs the cell as ``run.py --trace 1`` does (which
records the spans under ``myfm_tpu_torch.tracing.recording()``), keeps
the profiler's events of the traced slice and prints one JSON line
(``fmbench.spans.report``): the span metrics, host ms per sweep by span,
device ms per sweep by the span that launched it, the idle gaps named by
span, and the cross-checks, with the run's own per-layer metrics
(``run_metrics``, as ``run.py --trace 1`` prints them) beside them.
With ``--overhead N`` it instead runs the cell untraced N times in one
process on the one seed, recording and not in turns
(on, off, off, on, ...), and prints each run's sweeps per second and
the time the garbage collector took, then the host cost of a span, off
and recording, in µs.  The benchmark's runs never run this; ``run.py``
records the spans in its traced runs only.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def span_cost_us(n: int = 200_000) -> dict:
    """Host µs per ``with span(...)`` with tracing off and recording (no
    profiler)."""
    from myfm_tpu_torch import tracing

    def loop():
        t0 = time.perf_counter()
        for i in range(n):
            with tracing.span("myfm.cost", sweep=i):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with tracing.recording():
        on = loop()
    return dict(off_us=off, recording_us=on)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=40.0)
    parser.add_argument("--overhead", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from fmbench import cell, spans
    from fmbench import trace as trace_mod
    from myfm_tpu_torch import tracing

    card = torch.cuda.get_device_name(0)
    if args.overhead:
        gc_s = [0.0]

        def gc_clock(phase, info, t=[0.0]):
            if phase == "start":
                t[0] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - t[0]

        gc.callbacks.append(gc_clock)
        for k in range(args.overhead):
            # on, off, off, on, on, off, ...: each side as often first
            on = k % 4 in (0, 3)
            gc_s[0], counts = 0.0, [g["collections"] for g in gc.get_stats()]
            with (tracing.recording() if on
                  else contextlib.nullcontext()) as rec:
                result, observed = cell.run_cell(
                    args.workload, args.seed, args.seconds, False,
                    time.perf_counter())
            print(json.dumps(dict(
                run=k, recording=on, correct=result["correct"],
                sweeps_per_s=observed["sweeps_per_s"],
                window_sweeps=observed["window_sweeps"],
                spans=len(rec.spans) if on else 0,
                gc_s=gc_s[0], gc_collections=[
                    g["collections"] - c
                    for g, c in zip(gc.get_stats(), counts)],
                card=card)), flush=True)
            del rec
        print(json.dumps(dict(span_cost=span_cost_us(), card=card)))
        return 0

    kept = {}
    summarize = trace_mod.summarize

    def keep_events(events, top=10):
        kept["events"] = list(events)
        return summarize(kept["events"], top)

    trace_mod.summarize = keep_events
    result, observed = cell.run_cell(args.workload, args.seed, args.seconds,
                                     True, T_START)
    recorded, fit = observed["spans"]["records"], observed["spans"]["fit"]
    out = spans.report(recorded, kept.pop("events"), observed,
                       cell.SLICE_AFTER)
    out.update(workload=args.workload, seed=args.seed,
               correct=result["correct"], card=card,
               sweeps_per_s=observed["sweeps_per_s"],
               window_sweeps=observed["window_sweeps"],
               slice_sweeps=observed["trace"]["sweeps"],
               kernel1_launches_per_sweep=observed["kernel1_launches"]
               / observed["window_sweeps"],
               kernel1_spans_per_sweep=sum(
                   1 for s in recorded if s.name == "myfm.sweep.kernel1"
                   and s.fit == fit and 1 <= s.sweep
                   <= observed["window_sweeps"])
               / observed["window_sweeps"],
               eval_callback_ms=(1e3 * sum(observed["callback_s"])
                                 / len(observed["callback_s"])
                                 if observed["callback_s"] else None),
               run_metrics={k: m["value"]
                            for k, m in result["metrics"].items()})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
