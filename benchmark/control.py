"""Control runs for the comparison's limits, several seeds in one process.

    python3 benchmark/control.py --workload ml10m_r128.chain \\
        --seeds 101,102,103 --seconds 4 [--force-gram bf16] [--trace 1]

Runs the cell once per seed, as ``run.py`` does but in one process, with
the control in the program's place, and prints one JSON line per seed:
``correct`` and ``checks`` as the run judged the control, and the
program's own compared numbers of the same run (``program_checks``).
The control is the plain reference computed one precision below the
configuration's (the Gram operands in ``precision.control_gram``, the
hyperparameters' statistics and the held-out forward in
``precision.control_float``); with ``--force-gram`` it is the program in
another Gram mode of its own (the control of a cell whose configuration
states "split": the program's "bf16"), judged as ``run.py`` judges it.
A control has to come out not correct.  The benchmark's runs never run
this.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--force-gram", default=None)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    from fmbench import cell

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, observed = cell.run_cell(
            args.workload, seed, args.seconds, bool(args.trace), t0,
            force_gram=args.force_gram, control=args.force_gram is None)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, force_gram=args.force_gram,
            correct=result["correct"], checks=result["checks"],
            program_checks=observed["program_checks"],
            metrics=result["metrics"], sweeps=observed["window_sweeps"],
            sweep_ms=statistics.quantiles(observed["sweep_ms"], n=20)[::6],
            setup_parts=observed["setup_parts"],
            check_s=time.perf_counter() - t0 - observed["window_s"]
            - result["metrics"].get("setup_s", {}).get("value", 0.0),
        ), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
