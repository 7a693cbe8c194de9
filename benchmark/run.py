"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 benchmark/run.py --workload ml10m_r128.chain --seed 1 \\
        --seconds 20 --trace 0

from the root of a checkout.  Prints the card, then as the last lines of
standard error each compared number beside its limit, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Exits non-zero without a result
when no CUDA card is there, or when the process has loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in spec["workloads"] if w["name"] == args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"run.py: {entry['chips']} CUDA card(s) wanted, {found} found",
              file=sys.stderr)
        return 2

    from fmbench import cell

    result, observed = cell.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START, spec=spec)
    # read after the run, so that set-up does not wait on it
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | {smi} | torch {torch.__version__}",
          file=sys.stderr, flush=True)
    print("set-up s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in observed["setup_parts"].items()),
        file=sys.stderr)
    if "trace" in observed:
        t = observed["trace"]
        print(f"trace: kernel 1 calls {len(t['kernel1_bound_ms'])}, Gram "
              f"passes {t['kernel1_passes']}, carry walks "
              f"{t['kernel1_carries']}, {t['kernel1_device_ms']:.3f} ms",
              file=sys.stderr)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"run.py: the process loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              + (f" at {c['at']}" if c.get("at") else ""), file=sys.stderr)
    sys.stderr.flush()
    for c in result["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
