"""The joint sweep's color tail (kernel 4, ``joint_tail_pass``) alone on
the real ML-100k tails, on a CUDA card.

It builds the joint plan of ``chip_smoke.py`` (synthetic MovieLens-100k
fold 0, the timeSVD++-flipped features, ``compile_design(...,
joint_dense=True, joint_rank=R)``, float32), takes the initial state's
hyperparameters drawn as a sweep draws them, and for each block's tail
stack prints one JSON line:

* the tail's shape (C colors, B block rows, Pf slots) and, per color,
  the distribution of touched rows and of live slots (slots that own
  rows);
* the kernel against the plain version in float32 and float64, within
  ``JTAIL_TOL`` of the output's scale (as ``chip_smoke.py``);
* float32 times: CUDA events around 5 calls (``ms``, the wrapper's host
  work included), the device time of one call by ``torch.profiler``
  (``tools/vi_gram.device_ms``: each kernel's median duration, the prep
  kernel as ``prep_ms`` and the chain as ``chain_ms``; a trace that lost
  or repeated calls' events is taken again, and the tool fails if none
  is whole), µs per color (of the two kernels), and the least time the
  card could take (the bytes moved over 3.35 TB/s);
* the phase split of the chain's timed instantiation (the library
  ``joint_tail_timed``, built beside the production one): the cycles
  that the chain's first thread spent in each phase, summed over the
  colors, as a share and as µs per color (the share of ``chain_ms``).

``--stacks ea`` takes instead the color stacks of the Gibbs fast path's
entity+attribute tables on the same design (``try_compile_categorical(...,
allow_side=True)``, float32): per side table, its side features' colors
(one call, Pf the widest color) on the flat Gram that ``_ea_table_pass``
scans, from the initial state, with a zero Atot/Ct carry.

Run it on the card (about a minute):

    python -m myfm_tpu_torch.tools.joint_tail [--rank 10|32] [--stacks joint|ea]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch

from ..ops import _build, joint_tail
from .kernel_sections import _bound, _nbytes, cuda_ms
from .vi_gram import card_line, device_ms

# |kernel − plain| over max |plain| of each output after ~1k chained
# colors (chip_smoke.py's JTAIL_TOL)
JTAIL_TOL = {"float32": 1e-3, "float64": 1e-10}
# the kernels of one joint_tail_pass call, by name (tools/vi_gram.device_ms)
TAIL_KINDS = (("prep", "tail_prep_kernel"), ("chain", "joint_tail_kernel"))


def tail_operands(rank: int, device="cuda") -> List[dict]:
    """Each block tail's float32 operands [G, Atot, Ct, xw, segb, u0, lam,
    mu, xi] and alpha, from the initial state of the ML-100k joint plan
    (as chip_smoke.py's jkernel phase builds them)."""
    # deterministic torch ops, as chip_smoke.py's jkernel phase: the same
    # operands, bit for bit, on every run
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _tail_operands(rank, device)
    finally:
        torch.use_deterministic_algorithms(False)


def _tail_operands(rank: int, device) -> List[dict]:
    from ..design import compile_design
    from ..ops.forward import factor_q
    from ..ops.gibbs import GibbsConfig, draw_gibbs_variates, draw_hypers
    from ..ops.joint import build_block_gram, dense_tail_operands
    from ..trainer import GibbsTrainer
    from ..utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    train, test = load_synthetic_movielens("100k", 0)
    X, _, blocks, _, grouping = build_feature_blocks(
        train, test, "timesvdpp_flipped")
    plan = compile_design(X, blocks, grouping=np.asarray(grouping, np.int32),
                          dtype=np.float32, joint_dense=True,
                          joint_rank=rank, device=device)
    trainer = GibbsTrainer(plan, train["rating"],
                           GibbsConfig(task="regression", joint_rows=True),
                           rank, 0.1, 0)
    state = trainer._initialize()
    v = draw_gibbs_variates(plan, trainer.cfg, rank, trainer.generator,
                            torch.float32, trainer.device)
    h = draw_hypers(plan, state, v, trainer.cfg)
    U = torch.cat([h.w[:, None], h.V], dim=1)
    lam = torch.cat([h.lambda_w[:, None], h.lambda_V], dim=1)
    mu = torch.cat([h.mu_w[:, None], h.mu_V], dim=1)
    q = factor_q(plan, h.V)
    tails = []
    for bi, b in enumerate(plan.blocks):
        ds = b.dense_stack
        if ds is None:
            continue
        B = ds.xw.shape[1]
        G = build_block_gram(b, h.e, q, flat=True).T.contiguous()
        ops = [G, G.new_zeros((rank, B)), G.new_zeros((B,)), ds.xw, ds.segb,
               *dense_tail_operands(b, U, lam, mu, v.noise,
                                    plan.group_index)]
        tails.append(dict(block=bi, ops=ops, alpha=h.alpha))
    return tails


def ea_operands(rank: int, device="cuda") -> List[dict]:
    """Each entity+attribute table's float32 scan operands [G, Atot, Ct,
    xw, segb, u0, lam, mu, xi] and alpha on the ML-100k Gibbs fast-path
    plan (``ea_stacks`` at the initial state), under deterministic torch
    ops."""
    from ..design_categorical import try_compile_categorical
    from ..ops.gibbs import GibbsConfig
    from ..trainer import CategoricalGibbsTrainer
    from ..utils.ml_features import (
        build_feature_blocks,
        load_synthetic_movielens,
    )

    train, test = load_synthetic_movielens("100k", 0)
    X, _, blocks, _, grouping = build_feature_blocks(
        train, test, "timesvdpp_flipped")
    plan = try_compile_categorical(
        X, blocks, np.asarray(grouping, np.int32), None, np.float32, device,
        rank=rank, allow_side=True)
    trainer = CategoricalGibbsTrainer(plan, train["rating"],
                                      GibbsConfig(task="regression"), rank,
                                      0.1, 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return ea_stacks(plan, trainer, trainer._initialize(), rank)
    finally:
        torch.use_deterministic_algorithms(False)


def ea_stacks(plan, trainer, state, rank: int) -> List[dict]:
    """Each entity+attribute table's color-scan operands as
    ``_ea_table_pass`` hands them to ``joint_tail_pass`` in a sweep's
    first pass from ``state``: the sweep's hyperparameters and noise
    drawn from the trainer's generator, the table's kernel-1 Gram over
    its effective rows as the flat [1 | e | Q] Gram, a zero Atot/Ct
    carry, the side features' pre-gathered rows."""
    from ..ops.categorical import (
        _build_table_gram,
        draw_sweep_variates,
        ea_flat_gram,
        ea_scan_operands,
        eff_tables,
        sweep_hypers,
    )

    c = state.core
    v = draw_sweep_variates(plan, trainer.cfg, rank, trainer.generator,
                            c.V.dtype, c.V.device)
    alpha, w0, lambda_w, mu_w, lambda_V, mu_V = sweep_hypers(
        plan, state, v, trainer.cfg)
    eff = eff_tables(plan, c.w, c.V)
    tails = []
    for ti, si in enumerate(plan.side):
        if si is None:
            continue
        G = _build_table_gram(plan, ti, c.w, c.V, eff, eff[ti],
                              trainer.y_tiles[ti], plain=False,
                              fast_matmul=trainer.cfg.gram_fast_matmul)
        Gf = ea_flat_gram(G, w0, eff[ti])
        B = Gf.shape[1]
        ops = [Gf, Gf.new_zeros((rank, B)), Gf.new_zeros((B,)),
               si.stack_xw, si.stack_segb,
               *ea_scan_operands(si, c.w, c.V, lambda_w, mu_w, lambda_V,
                                 mu_V, plan.group_index, v.noise_w,
                                 v.noise_V)]
        tails.append(dict(block=ti, ops=ops, alpha=alpha))
    return tails


def distribution(segb: torch.Tensor, Pf: int) -> Dict[str, float]:
    """Per color: touched rows (segb < Pf) as mean / median / p90 / max,
    live slots (slots owning a row) as mean / max."""
    sg = segb.long().cpu()
    touched = (sg < Pf).sum(dim=1).double().numpy()
    counts = torch.nn.functional.one_hot(sg, Pf + 1)[..., :Pf].sum(dim=1)
    live = (counts > 0).sum(dim=1).double().numpy()
    return dict(touched_mean=float(touched.mean()),
                touched_median=float(np.median(touched)),
                touched_p90=float(np.percentile(touched, 90)),
                touched_max=float(touched.max()),
                live_mean=float(live.mean()), live_max=float(live.max()))


def cast(ops, dtype):
    return [t if t.dtype == torch.int32 else t.to(dtype) for t in ops]


def check(fn, ops, alpha, D) -> Dict[str, float]:
    """``fn`` against the plain version in float64 and float32: max error
    (``err_*``) and that over max |plain| (``rel_*``).  float64 must lie
    within ``JTAIL_TOL``; float32 too, or else no farther from the
    float64 plain result than twice the float32 plain version's own
    distance from it (where the draws' conditioning, not the kernel,
    sets the float32 error).  Raises otherwise."""
    row = {}
    exact = None
    for name in ("float64", "float32"):
        tol = JTAIL_TOL[name]
        dtype = getattr(torch, name)
        o = cast(ops, dtype)
        out = fn(*o, alpha.to(dtype), D)
        ref = joint_tail.joint_tail_pass_reference(*o, alpha.to(dtype), D)
        if name == "float64":
            exact = ref
        err = rel = 0.0
        for a, r in zip(out, ref):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite output")
            e = float((a - r).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(r.abs().max()), 1.0))
        row[f"err_{name}"], row[f"rel_{name}"] = err, rel
        if rel <= tol:
            continue
        if name == "float32":
            kernel_off = _off(out, exact)
            plain_off = _off(ref, exact)
            row.update(rel_float32_vs_float64=kernel_off,
                       plain_rel_float32_vs_float64=plain_off)
            if kernel_off <= max(tol, 2.0 * plain_off):
                continue
        raise AssertionError(f"{name}: max error {rel:.3e} of scale > "
                             f"{tol:.0e}")
    return row


def _off(got, exact) -> float:
    """Largest distance of ``got`` from ``exact`` over max |exact|."""
    return max(float((a.double() - x).abs().max())
               / max(float(x.abs().max()), 1.0)
               for a, x in zip(got, exact))


def phase_split(ops, alpha, D, chain_ms: float, C: int) -> dict:
    """The timed instantiation's cycles per phase, as shares and as µs per
    color (each share of ``chain_ms``, the chain's device time)."""
    _, cycles = joint_tail.joint_tail_phases(*ops, alpha, D)
    cyc = cycles.double()
    n = len(joint_tail.PHASES)
    total = float(cyc[:n].sum())
    names = joint_tail.PHASES + joint_tail.SUB_PHASES
    out = {name: dict(cycles=int(cycles[k]),
                      share=float(cyc[k]) / total,
                      us_per_color=float(cyc[k]) / total * chain_ms * 1e3 / C)
           for k, name in enumerate(names)}
    # the cycles over the untimed chain's device time: the SM clock as
    # the chain ran, if the timed instantiation took as long
    out["clock_ghz"] = total / (chain_ms * 1e6)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m myfm_tpu_torch.tools."
                                      "joint_tail")
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--stacks", choices=("joint", "ea"), default="joint")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("joint_tail: no CUDA device", file=sys.stderr)
        return 1
    logs = _build.build_all(("joint_tail", "joint_tail_timed"))
    print(f"device {torch.cuda.get_device_name(0)} | {card_line()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for log in logs.values():
        print("ptxas: " + ", ".join(_build.ptxas_summary(log)), flush=True)
    D = args.rank + 2
    stacks = tail_operands if args.stacks == "joint" else ea_operands
    for tail in stacks(args.rank):
        ops, alpha = tail["ops"], tail["alpha"]
        C, B = ops[3].shape
        Pf = ops[5].shape[1]
        row = dict(stacks=args.stacks, block=tail["block"], rank=args.rank,
                   C=C, B=B, Pf=Pf)
        row.update(distribution(ops[4], Pf))
        row.update(check(joint_tail.joint_tail_pass, ops, alpha, D))

        def run():
            return joint_tail.joint_tail_pass(*ops, alpha, D)

        row["ms"] = cuda_ms(run, 5)
        row.update(device_ms(run, reps=5, kinds=TAIL_KINDS))
        row["us_per_color"] = (row["prep_ms"] + row["chain_ms"]) * 1e3 / C
        out = run()
        row["bound_ms"], row["bound_by"] = _bound(_nbytes(*ops, *out), 0)
        row["phases"] = phase_split(ops, alpha, D, row["chain_ms"], C)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
