"""The Gram kernels alone at the VI shapes and the Gibbs square, on a CUDA
card.

The short loop for the Gram pass (``gram_pass`` in csrc/gram_tile.cuh)
that every pass-1 kernel runs, on synthetic operands packed as the fast
path packs a table (skewed entity counts, T and S from ``choose_tiling``,
the first chunk of tiles).  The VI shapes run the rectangle
(``out_rows < D``): kernel 1's VI layout
``fused_tile_gram_cross(..., q_lo=2, n_extra=2R, out_rows=2+R)`` and
kernel 2 ``fused_tile_gram(..., out_rows=2+R)``, packed at ``rank=3R``:

  100k      rank 10: D = 32, out_rows 12 (T = 256); 90,000 rows, 943
            entities
  10m       rank 32: D = 98, out_rows 34 (T = 128); one 1M-row chunk

The square shape runs the full D x D Gram: kernel 1's Gibbs layout
(``q_lo=1, n_extra=0``) and kernel 3 ``tile_gram`` on the z rows that
``gram.cross_rows`` builds from the same operands, packed at ``rank=R``:

  gibbs10m  rank 32: D = 34 (T = 256); one 1M-row chunk
  gibbs100k rank 10: D = 12; 90,000 rows, 943 entities (the ML-100k
            fast path's calls of a few hundred tiles)
  r128days, r128users, r128items (``r128`` names all three)
            rank 128: D = 130 (T = 128); the first call of each table of
            the smoke's ML-10M design (``tools/carry_chains.design_tables``:
            90% of the synthetic ML-10M rows), packed as the plan packs it

For each kernel and shape it prints one JSON line: the kernel against
its plain version in float32 (within 1e-5 of the output's scale) and
float64 (1e-12); in float32 the time by CUDA events around 10 calls
(host work of the wrapper included), the device time of one call by
``torch.profiler`` (the median duration of each of the call's kernels:
pass 1, the carry walk, the workspace fills; a trace that misses
pass 1 or the carry, or holds far more or fewer events than the calls
launched, is taken again, and the tool fails if none is whole), the
least time the card could take (the bytes moved over 3.35 TB/s, or the
fp32 operations over 67 TFLOP/s if larger) and one ``torch.bmm`` of the
slot-masked operand as yardstick.  ``chip_smoke.py`` checks and times
every Gram kernel of the port with ``check``, ``time_kernel`` and
``device_ms``.

With ``--mode split`` or ``--mode bf16`` kernels 1 and 2 run in that
Gram mode (on the tensor cores; fp32 only, so float64 is not checked),
beside the bf16 ``torch.bmm`` yardstick (three summed for "split");
kernel 3 has IEEE only and is skipped.

With ``--other DIR`` (the root of another checkout, for example ``git
archive`` of a parent commit unpacked under ``build/``; it may be given
more than once), that checkout's ``ops.gram`` is loaded beside this one
(its kernels built from its own sources into its own directory) and
each kernel is timed on the same operands in turns, other, this, this,
other (``ab[DIR]``: CUDA-event and device ms of each), with the largest
difference of the outputs.

Run it on the card:

    python -m myfm_tpu_torch.tools.vi_gram [100k|10m|gibbs10m|gibbs100k|r128 ...] \
        [--mode highest|split|bf16] [--other DIR ...]
"""

from __future__ import annotations

import functools
import importlib
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..design_categorical import compile_categorical_table
from ..ops import _build, gram
from .kernel_sections import (_bound, _nbytes, cuda_ms, gram_products,
                              gram_yardstick)

SHAPES = {
    "100k": dict(rank=10, n_rows=90_000, n_entities=943),
    "10m": dict(rank=32, n_rows=1 << 20, n_entities=7_000),
}
SQUARE_SHAPES = {
    "gibbs10m": dict(rank=32, n_rows=1 << 20, n_entities=7_000),
    "gibbs100k": dict(rank=10, n_rows=90_000, n_entities=943),
    **{f"r128{t}": dict(rank=128, n_rows=0, n_entities=0, table=t)
       for t in ("days", "users", "items")},
}
# names that stand for several shapes
GROUPS = {"r128": ["r128days", "r128users", "r128items"]}
# |kernel − plain| over max |plain|: the same sums over up to ~10^4 rows
# per carried chain in another order
TOL = {"float32": 1e-5, "float64": 1e-12}
ZIPF = 0.7  # entity n draws rows in proportion to (n + 1)^-ZIPF


@functools.lru_cache(maxsize=1)
def _design_tables():
    from .carry_chains import design_tables

    return {name: (ent, B) for name, ent, B in design_tables("10m")}


def _packing(rank: int, n_rows: int, n_entities: int, seed: int,
             fixed_ts=None, pack_rank=None, table: Optional[str] = None):
    """A table packed at the Gram's width (``pack_rank``, by default the
    VI Gram's ``3R``) from skewed entity counts, or the ML-10M design's
    table ``table`` as the plan packs it, cut to its first chunk of
    tiles: (table, K, flags)."""
    pack = 3 * rank if pack_rank is None else pack_rank
    if table is not None:
        ent, B = _design_tables()[table]
        tab = compile_categorical_table(ent, B, 0, ent.shape[0], np.float32,
                                        "cpu", rank=pack, max_inflation=4.0)
    else:
        rng = np.random.RandomState(seed)
        p = (1.0 + np.arange(n_entities)) ** -ZIPF
        counts = rng.multinomial(n_rows, p / p.sum())
        ent = np.repeat(rng.permutation(n_entities), counts)
        tab = compile_categorical_table(
            ent, n_entities, 0, n_rows, np.float32, "cpu", rank=pack,
            fixed_ts=fixed_ts)
    K = min(tab.chunk_tiles, tab.n_tiles)
    flags = [f[:K].contiguous() for f in (tab.cont_in, tab.cont_out,
                                          tab.last_slot)]
    return tab, K, flags


def cross_operands(rank: int, n_rows: int, n_entities: int, seed: int = 0,
                   device="cuda", fixed_ts=None):
    """Kernel 1's VI-layout operands in float32: ([aux2, gths, wvsl,
    cont_in, cont_out, last_slot], S, keywords).  The gathered rows of
    two other tables (as on ML-10M: user, item, date) are
    [w | wvar | V | σ | sv | qs] (3 + 3R columns), zero on pad rows;
    own rows [w | V | qs]."""
    tab, K, flags = _packing(rank, n_rows, n_entities, seed, fixed_ts)
    T, S, R = tab.tile_rows, tab.tile_entities, rank
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    slot_f = tab.slot_f[: K * T].reshape(K, T).to(device)
    valid = (slot_f < S).float()[:, :, None]
    gths = []
    for _ in range(2):
        V = 0.3 * randn(K, T, R)
        s = 0.1 * torch.rand((K, T, R), generator=g, device=device) + 0.01
        body = torch.cat([randn(K, T, 1), randn(K, T, 1).abs(), V, s, s * V,
                          (V * V).sum(dim=2, keepdim=True)], dim=2)
        gths.append((body * valid).contiguous())
    wv = 0.3 * randn(K, S, 1 + R)
    wvsl = torch.cat([wv, (wv[:, :, 1:] ** 2).sum(dim=2, keepdim=True)],
                     dim=2).contiguous()
    aux2 = torch.stack([slot_f, 3.0 + randn(K, T) * valid[:, :, 0]], dim=1)
    ops = [aux2.contiguous(), gths, wvsl] + [f.to(device) for f in flags]
    return ops, S, dict(q_lo=2, n_extra=2 * R, out_rows=2 + R)


def meta_operands(rank: int, n_rows: int, n_entities: int, seed: int = 0,
                  device="cuda", fixed_ts=None):
    """Kernel 2's operands in float32 as the VI entity+attribute pass
    gives them: ([meta, q_other, slot, wvsl, cont_in, cont_out,
    last_slot], S, keywords), with meta = [ones | lin − τ | qs_other],
    ones = 0 on pad rows, q_other [K, T, 3R], own rows [w | V]."""
    tab, K, flags = _packing(rank, n_rows, n_entities, seed, fixed_ts)
    T, S, R = tab.tile_rows, tab.tile_entities, rank
    g = torch.Generator(device=device).manual_seed(seed + 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    ones = (tab.src[: K * T].reshape(K, T) < n_rows).float().to(device)
    meta = torch.stack([ones, (3.0 + randn(K, T)) * ones,
                        torch.rand((K, T), generator=g, device=device)
                        * ones], dim=2)
    q_other = 0.3 * randn(K, T, 3 * R) * ones[:, :, None]
    wvsl = 0.3 * randn(K, S, 1 + R)
    slot = tab.slot[: K * T].reshape(K, T).contiguous().to(device)
    ops = [meta.contiguous(), q_other.contiguous(), slot, wvsl.contiguous()]
    return ops + [f.to(device) for f in flags], S, dict(out_rows=2 + R)


def _gibbs(rank: int, n_rows: int, n_entities: int, seed: int, device,
           fixed_ts, table=None):
    """Kernel 1's Gibbs-layout operands in float32, packed at ``rank=R``,
    and the packing's slot per tile row [K, T] (pad rows at slot 0)."""
    tab, K, flags = _packing(rank, n_rows, n_entities, seed, fixed_ts,
                             pack_rank=rank, table=table)
    T, S, R = tab.tile_rows, tab.tile_entities, rank
    g = torch.Generator(device=device).manual_seed(seed + 2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    slot_f = tab.slot_f[: K * T].reshape(K, T).to(device)
    valid = (slot_f < S).float()[:, :, None]
    gths = []
    for _ in range(2):
        V = 0.3 * randn(K, T, R)
        body = torch.cat([randn(K, T, 1), V,
                          (V * V).sum(dim=2, keepdim=True)], dim=2)
        gths.append((body * valid).contiguous())
    wv = 0.3 * randn(K, S, 1 + R)
    wvsl = torch.cat([wv, (wv[:, :, 1:] ** 2).sum(dim=2, keepdim=True)],
                     dim=2).contiguous()
    aux2 = torch.stack([slot_f, 3.0 + randn(K, T) * valid[:, :, 0]], dim=1)
    ops = [aux2.contiguous(), gths, wvsl] + [f.to(device) for f in flags]
    return ops, S, tab.slot[: K * T].reshape(K, T).contiguous().to(device)


def gibbs_operands(rank: int, n_rows: int, n_entities: int, seed: int = 0,
                   device="cuda", fixed_ts=None, table=None):
    """Kernel 1's Gibbs-layout operands in float32: ([aux2, gths, wvsl,
    cont_in, cont_out, last_slot], S, {}).  The gathered rows of two
    other tables are [w | V | qs] (R + 2 columns), zero on pad rows; own
    rows [w | V | qs]."""
    ops, S, _ = _gibbs(rank, n_rows, n_entities, seed, device, fixed_ts,
                       table)
    return ops, S, {}


def rows_operands(rank: int, n_rows: int, n_entities: int, seed: int = 0,
                  device="cuda", fixed_ts=None, table=None):
    """Kernel 3's operands as ``entity_grams`` gives them: ([rows, slot,
    cont_in, cont_out, last_slot], S, {}), rows [K, T, R + 2] the z rows
    that ``gram.cross_rows`` builds from ``gibbs_operands`` (zero on pad
    rows), slot the packing's."""
    ops, S, slot = _gibbs(rank, n_rows, n_entities, seed, device, fixed_ts,
                          table)
    z, _ = gram.cross_rows(ops[0], ops[1], ops[2], S)
    return [z.contiguous(), slot] + ops[3:], S, {}


def _slot_mask(o, S):
    return o[0], (o[1].long()[:, :, None] == torch.arange(
        S, device=o[1].device)).to(o[0].dtype)


# name -> (operand builder, kernel, plain version, z rows and slot mask)
KERNELS = {
    "fused_tile_gram_cross[vi]": (
        cross_operands, gram.fused_tile_gram_cross,
        gram.fused_tile_gram_cross_reference,
        lambda o, S: gram.cross_rows(o[0], o[1], o[2], S, 2,
                                     2 * (o[2].shape[2] - 2)),
    ),
    "fused_tile_gram": (
        meta_operands, gram.fused_tile_gram, gram.fused_tile_gram_reference,
        lambda o, S: gram.meta_rows(o[0], o[1], o[2], o[3], S),
    ),
}
# the same for the square shapes
SQUARE_KERNELS = {
    "fused_tile_gram_cross": (
        gibbs_operands, gram.fused_tile_gram_cross,
        gram.fused_tile_gram_cross_reference,
        lambda o, S: gram.cross_rows(o[0], o[1], o[2], S),
    ),
    "tile_gram": (
        rows_operands, gram.tile_gram, gram.tile_gram_reference, _slot_mask,
    ),
}


def cast(ops, dtype):
    """The operands with every float tensor (also inside lists) in
    ``dtype``; index tensors are kept."""
    def one(t):
        return t.to(dtype) if t.is_floating_point() else t

    return [[one(g) for g in o] if isinstance(o, list) else one(o)
            for o in ops]


def check(kernel, plain, ops: Sequence, S: int, kw: dict,
          tol=TOL) -> Dict[str, float]:
    """A Gram kernel against its plain version in float32 and float64:
    per dtype the max error of the output and the carry (``err_*``) and
    that over max |plain| (``rel_*``); raises AssertionError above
    ``tol`` (by dtype name).  On CPU tensors the wrapper runs the plain
    version itself."""
    row = {}
    for name, t in tol.items():
        o = cast(ops, getattr(torch, name))
        out, carry = kernel(*o, S, **kw)
        ref, ref_carry = plain(*o, S, **kw)
        if out.is_cuda:
            torch.cuda.synchronize()
        err = max(float((out - ref).abs().max()),
                  float((carry - ref_carry).abs().max()))
        row[f"err_{name}"] = err
        row[f"rel_{name}"] = err / max(float(ref.abs().max()), 1.0)
        if not row[f"rel_{name}"] <= t:
            raise AssertionError(f"{name}: max error {row[f'rel_{name}']:.3e}"
                                 f" of scale > {t:.0e}")
    return row


# the Gram kernels' kinds: the carry (``carry_*``), pass 1 (``*tile_kernel``)
GRAM_KINDS = (("carry", "carry_"), ("pass1", "tile_kernel"))


def kernel_split(durations: Dict[str, List[float]], reps: int,
                 kinds: Sequence[Tuple[str, str]] = GRAM_KINDS
                 ) -> Dict[str, float]:
    """Device milliseconds per call from each kernel's traced durations
    (µs) over ``reps`` calls that launch every kernel once: the median
    duration of each kernel, summed by kind -- the first (key, part) of
    ``kinds`` whose part is in the kernel's name, else "other" (fills)
    -- as ``<key>_ms``, and in all.  A median, not a sum over reps,
    because a trace late in a long process may lose some of the events,
    or hold a few more; ``captured`` is the share it held.  Raises
    ValueError for a trace without a kind of ``kinds``, or with
    ``captured`` outside [0.5, 1.5]."""
    out = {f"{key}_ms": 0.0 for key, _ in kinds}
    out["other_ms"] = 0.0
    seen = set()
    for name, us in durations.items():
        key = next((k for k, part in kinds if part in name), "other")
        out[f"{key}_ms"] += statistics.median(us) / 1e3
        seen.add(key)
    out["device_ms"] = sum(out.values())
    n = sum(len(us) for us in durations.values())
    out["captured"] = n / (reps * max(len(durations), 1))
    if (not {key for key, _ in kinds} <= seen
            or not 0.5 <= out["captured"] <= 1.5):
        raise ValueError(f"incomplete trace: kinds {sorted(seen)}, "
                         f"captured {out['captured']:.2f}")
    return out


def device_ms(fn, reps: int = 10, attempts: int = 3,
              kinds: Sequence[Tuple[str, str]] = GRAM_KINDS
              ) -> Dict[str, float]:
    """``kernel_split`` (by ``kinds``) of ``reps`` calls of ``fn`` traced
    by torch.profiler after one warm-up.  A trace in a process that has
    traced before can receive kernel events late, or none: a first trace
    of one call takes what earlier traces left, and a trace that
    ``kernel_split`` refuses is taken again, up to ``attempts`` times;
    then RuntimeError."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    why = None
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durations: Dict[str, List[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                durations.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        try:
            return kernel_split(durations, reps, kinds)
        except ValueError as exc:
            why = exc
    raise RuntimeError(f"device_ms: {attempts} traces, none whole ({why})")


def time_kernel(kernel, rows_of, ops: Sequence, S: int, kw: dict,
                row_ops: int = 4, reps: int = 10) -> dict:
    """Times of one call on ``ops`` in the Gram mode of ``kw``
    (``fast_matmul``): by CUDA events around ``reps`` calls (``ms``, the
    wrapper's host work included), the one-call yardstick of the
    slot-masked operand (``library_ms``: ``gram_yardstick``, a torch.bmm
    in fp32, or in bf16, three of them for "split") and the bound of the
    work on these rows (inputs read once, outputs written once; per valid
    row the rectangle's unique entries, two operations per product, on
    the tensor cores in the reduced modes, and ``row_ops`` D fp32
    operations to build the row)."""
    mode = gram.gram_mode(kw.get("fast_matmul", False))
    row = dict(ms=cuda_ms(lambda: kernel(*ops, S, **kw), reps))
    out, carry = kernel(*ops, S, **kw)
    z, m = rows_of(ops, S)
    rows, D = out.shape[1], out.shape[2]
    mz = gram.masked_rows(z, m, rows).transpose(1, 2)
    row["library_ms"] = cuda_ms(gram_yardstick(mode, mz, z), reps)
    n_valid = int((m.sum(dim=2) > 0).sum())
    pairs = rows * (rows + 1) // 2 + rows * (D - rows)
    flat = [t for x in ops for t in (x if isinstance(x, list) else [x])]
    moved = _nbytes(*flat, out, carry) + carry.numel() * 4
    gram_flops = n_valid * 2 * pairs * gram_products(mode)
    build_flops = n_valid * row_ops * D
    if mode == "highest":
        row["bound_ms"], row["bound_by"] = _bound(
            moved, gram_flops + build_flops)
    else:
        row["bound_ms"], row["bound_by"] = _bound(moved, build_flops,
                                                  gram_flops)
    return row


def other_gram(root: str, i: int = 0):
    """The ``ops.gram`` module of the checkout at ``root``, loaded as a
    package of another name (``myfm_tpu_torch_other<i>``; its kernels
    build into its own directory)."""
    home = Path(__file__).resolve().parents[2] / "build" / "vi_gram_other"
    dst = home / f"myfm_tpu_torch_other{i}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(root).resolve() / "myfm_tpu_torch", dst)
    if str(home) not in sys.path:
        sys.path.insert(0, str(home))
    return importlib.import_module(f"myfm_tpu_torch_other{i}.ops.gram")


def ab(this, other, ops: Sequence, S: int, kw: dict) -> dict:
    """One call of kernel ``this`` and of ``other`` (another checkout's
    wrapper of the same kernel) on ``ops``, timed in turns other, this,
    this, other: CUDA-event ms (``cuda_ms`` of 10 calls) and the device
    split (``device_ms``) of each, and the largest difference of their
    outputs over the output's scale."""
    def one(fn):
        row = dict(ms=cuda_ms(lambda: fn(*ops, S, **kw), 10))
        try:
            row.update(device_ms(lambda: fn(*ops, S, **kw)))
        except RuntimeError as exc:
            row.update(device_ms=None, device_ms_error=str(exc))
        return row

    out = dict(other=[one(other)], this=[one(this), one(this)])
    out["other"].append(one(other))
    a, _ = this(*ops, S, **kw)
    b, _ = other(*ops, S, **kw)
    torch.cuda.synchronize()
    out["max_diff_vs_other"] = float((a - b).abs().max()) / max(
        float(b.abs().max()), 1.0)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv: Sequence[str]) -> int:
    if not torch.cuda.is_available():
        print("vi_gram: no CUDA device", file=sys.stderr)
        return 1
    argv = list(argv)
    mode = "highest"
    if "--mode" in argv:
        i = argv.index("--mode")
        mode = gram.gram_mode(argv[i + 1])
        del argv[i : i + 2]
    others = {}
    while "--other" in argv:
        i = argv.index("--other")
        others[argv[i + 1]] = other_gram(argv[i + 1], len(others))
        del argv[i : i + 2]
    shapes: List[str] = [s for a in argv for s in GROUPS.get(a, [a])] or [
        *SHAPES, "gibbs10m", "gibbs100k"]
    tol = TOL if mode == "highest" else {"float32": TOL["float32"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    logs = _build.build_all(("fused_gram_cross",))
    print(f"device {torch.cuda.get_device_name(0)} | {card_line()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for log in logs.values():
        print("ptxas: " + ", ".join(_build.ptxas_summary(log)), flush=True)
    for shape in shapes:
        square = shape in SQUARE_SHAPES
        kernels = SQUARE_KERNELS if square else KERNELS
        for name, (build, kernel, plain, rows_of) in kernels.items():
            if name == "tile_gram" and mode != "highest":
                continue
            ops, S, kw = build(**(SQUARE_SHAPES if square else SHAPES)[shape])
            if name != "tile_gram":
                kw = dict(kw, fast_matmul=mode)
            K = ops[0].shape[0]
            # aux2 [K, 2, T] (kernel 1), else [K, T, ...]
            T = ops[0].shape[2 if name.startswith("fused_tile_gram_cross")
                             else 1]
            row = dict(kernel=name, shape=shape, K=K, T=T, S=S, **kw)
            row.update(check(kernel, plain, ops, S, kw, tol))
            row.update(time_kernel(kernel, rows_of, ops, S, kw,
                                   row_ops=0 if name == "tile_gram" else 4))
            row.update(device_ms(lambda: kernel(*ops, S, **kw)))
            if others:
                row["ab"] = {root: ab(kernel, getattr(mod, kernel.__name__),
                                      ops, S, kw)
                             for root, mod in others.items()}
            print(json.dumps(row), flush=True)
            del ops
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
