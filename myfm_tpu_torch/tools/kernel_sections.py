"""Where kernel 1's time goes, section by section, and what its (slot, τ)
load costs, on a CUDA card.

The counterpart of the TPU package's ``scripts/microbench_kernel_sections.py``
and ``scripts/probe_transpose.py``.  It times kernel 1 (the fused cross
Gram, Gibbs layout) cut down to its first sections (ops/gram.py
``gram_section``, csrc/gram_sections.cu):

  level 0  operand loads into shared memory and the output writes
  level 1  + the Gram loop over the loaded rows
  level 2  + the cross sums, the score and the z build (production pass 1)
  level 3  + the carry walk (the whole production kernel)

beside each level's plain PyTorch version, one ``torch.bmm`` of the
slot-masked operand (the yardstick of levels 1-3; in the bf16 Gram modes
the bf16 ``torch.bmm``, three of them summed for "split") and each
level's least time on an H100 (the bytes it moves over 3.35 TB/s, or its
operations if longer: fp32 over 67 TFLOP/s, the Gram's bf16 products
over 989 TFLOP/s in the reduced modes).  Levels 1-3 run in a Gram mode
(``--mode``): "highest" (IEEE, the default), "split" or "bf16".  The
TPU script runs every level in "split" and level 1 in "bf16" too; it has
no IEEE mode.  Then the probe of kernel 1's [K, 2, T] aux2 load into
per-row pairs (``interleave_probe``) in its two variants beside
``x.transpose(1, 2).contiguous()``.

Run it on the card:

    python -m myfm_tpu_torch.tools.kernel_sections [T] [S] [rank] \
        [--mode highest|split|bf16]

(defaults 256 / 4 / 32 over 4M synthetic rows, as the TPU script).
``chip_smoke.py`` calls ``check_sections``, ``time_sections``,
``check_probe`` and ``time_probe`` on the real operands of the ML-10M
fast path.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops import gram

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, on the tensor cores
# |kernel − plain| over max |plain| per level in fp32: the same sums in
# another order (levels 0-1 sum a tile's ~10^4 operands into one value)
SECTION_TOL = 1e-5
LABELS = {
    0: "loads + output writes",
    1: "+ Gram loop on the loaded rows",
    2: "+ cross sums, score, z build (production pass 1)",
    3: "+ carry walk (whole production kernel)",
}


def synthetic_operands(T: int, S: int, rank: int, n_rows: int = 4_000_000,
                       seed: int = 0, device="cuda", n_cross: int = 2):
    """Kernel 1's operands for n_rows rows in tiles of T rows and S slots
    (the TPU script's: slots sorted per tile, every row valid, no entity
    continued across tiles)."""
    rng = np.random.RandomState(seed)
    K = max(1, n_rows // T)
    D = rank + 2
    slot = np.sort(rng.randint(0, S, (K, T)), axis=1).astype(np.float32)
    aux2 = np.stack([slot, rng.normal(size=(K, T)).astype(np.float32)], 1)

    def up(a):
        return torch.as_tensor(a, device=device)

    gths = [up((rng.normal(size=(K, T, D)) * 0.1).astype(np.float32))
            for _ in range(n_cross)]
    wvsl = up((rng.normal(size=(K, S, D)) * 0.1).astype(np.float32))
    zeros = torch.zeros(K, dtype=torch.int32, device=device)
    last = torch.full((K,), S - 1, dtype=torch.int32, device=device)
    return up(aux2), gths, wvsl, zeros, zeros.clone(), last


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(nbytes: float, flops: float, tc_flops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of ``nbytes`` over the
    card's memory rate and ``flops`` fp32 plus ``tc_flops`` bf16
    tensor-core operations over their peak rates."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = (flops / FP32_FLOPS_PER_S + tc_flops / BF16_FLOPS_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def gram_products(mode: str) -> int:
    """Products per Gram entry and row: 1 (IEEE, bf16) or 3 (split)."""
    return 3 if mode == "split" else 1


def gram_yardstick(mode: str, mz: torch.Tensor, z: torch.Tensor):
    """The one-call yardstick of a Gram of the masked operand ``mz``
    [K, S*rows, T] and z [K, T, D] in ``mode``: torch.bmm in fp32
    ("highest"), in bf16 ("bf16"), or the three bf16 products of the
    split summed ("split"; three calls, said so where it is printed)."""
    if mode == "highest":
        return lambda: torch.bmm(mz, z)
    a_hi, z_hi = mz.to(torch.bfloat16), z.to(torch.bfloat16)
    if mode == "bf16":
        return lambda: torch.bmm(a_hi, z_hi)
    a_lo = (mz - a_hi.to(mz.dtype)).to(torch.bfloat16)
    z_lo = (z - z_hi.to(z.dtype)).to(torch.bfloat16)
    return lambda: (torch.bmm(a_hi, z_hi) + torch.bmm(a_hi, z_lo)
                    + torch.bmm(a_lo, z_hi))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mode_levels(mode: str):
    """The section levels that run in ``mode``: all in IEEE, 1-3 in the
    reduced modes (level 0 has no Gram)."""
    return gram.SECTION_LEVELS if mode == "highest" else (1, 2, 3)


def check_sections(ops: Sequence, S: int,
                   mode: str = "highest") -> Dict[str, float]:
    """Each level of ``mode`` against its plain version in that mode (max
    error over max |plain|, or for levels 0-1 over the largest per-tile
    sum of |operands| that their checksum adds up, at most SECTION_TOL),
    and level 3 bit for bit against the production kernel in the same
    mode.
    Returns the errors; raises on a failed check."""
    aux2, gths, wvsl, ci, co, ls = ops
    abs_total = float((sum(g.abs().sum(dim=(1, 2)) for g in gths)
                       + wvsl.abs().sum(dim=(1, 2))
                       + aux2.abs().sum(dim=(1, 2))).max())
    errs = {}
    for level in mode_levels(mode):
        out, carry = gram.gram_section(level, aux2, gths, wvsl, ci, co, ls,
                                       S, mode)
        ref, _ = gram.gram_section_reference(level, aux2, gths, wvsl, ci,
                                             co, ls, S, mode)
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1.0,
                    abs_total if level <= 1 else 0.0)
        err = float((out - ref).abs().max())
        errs[f"level{level}_err"] = err
        if not err <= SECTION_TOL * scale:
            raise AssertionError(f"section level {level}: max error {err:.3e}"
                                 f" over scale {scale:.3e}")
        if level == 3:
            prod, prod_carry = gram.fused_tile_gram_cross(
                aux2, gths, wvsl, ci, co, ls, S, fast_matmul=mode)
            if not (torch.equal(out, prod) and torch.equal(carry,
                                                           prod_carry)):
                raise AssertionError(
                    f"section level 3 ({mode}) is not bit-equal to the "
                    "production kernel")
    return errs


def time_sections(ops: Sequence, S: int, reps: int = 10,
                  plain_reps: int = 2, mode: str = "highest",
                  levels: Sequence[int] = None) -> List[dict]:
    """Per level (by default every level of ``mode``): kernel ms, ns per
    row, plain ms, bound ms (and what bounds it), and the yardstick of
    the Gram levels (``gram_yardstick``)."""
    aux2, gths, wvsl, ci, co, ls = ops
    K, _, T = aux2.shape
    D = wvsl.shape[2]
    n_rows = K * T
    slot = aux2[:, 0, :].long()
    m = (slot[:, :, None] == torch.arange(S, device=slot.device)).to(
        wvsl.dtype)
    z, _ = gram.cross_rows(aux2, gths, wvsl, S)
    mz = gram.masked_rows(z, m, D).transpose(1, 2)
    raw = gram.masked_rows(gths[0], m, D).transpose(1, 2)
    bmm_ms = cuda_ms(gram_yardstick(mode, mz, z), reps)
    bmm_raw_ms = cuda_ms(gram_yardstick(mode, raw, gths[0]), reps)
    moved = _nbytes(aux2, wvsl, *gths) + K * S * D * D * 4
    n_valid = int((m.sum(dim=2) > 0).sum())
    gram_flops = n_valid * D * (D + 1) * gram_products(mode)
    rows = []
    for level in levels or mode_levels(mode):
        ms = cuda_ms(lambda: gram.gram_section(level, aux2, gths, wvsl, ci,
                                               co, ls, S, mode), reps)
        plain_ms = cuda_ms(lambda: gram.gram_section_reference(
            level, aux2, gths, wvsl, ci, co, ls, S, mode), plain_reps)
        flops = n_rows * D * len(gths)
        tc_flops = 0
        if level >= 1:
            if mode == "highest":
                flops += gram_flops
            else:
                tc_flops = gram_flops
        if level >= 2:
            flops += n_valid * 4 * D
        nbytes = moved + (K * 12 if level == 3 else 0)
        b_ms, b_by = _bound(nbytes, flops, tc_flops)
        rows.append(dict(
            level=level, mode=mode, what=LABELS[level], ms=ms,
            ns_per_row=ms * 1e6 / n_rows, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by,
            library_ms=(None if level == 0
                        else bmm_raw_ms if level == 1 else bmm_ms),
        ))
    return rows


def check_probe(x: torch.Tensor) -> None:
    """Both probe variants bit-equal to x.transpose(1, 2).contiguous()
    and to the plain version; raises otherwise."""
    want = x.transpose(1, 2).contiguous()
    plain = gram.interleave_probe_reference(x)
    if not torch.equal(plain, want):
        raise AssertionError("the probe's plain version is not the "
                             "transpose")
    for variant in gram.PROBE_VARIANTS:
        got = gram.interleave_probe(x, variant)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"interleave_probe[{variant}] is not "
                                 "bit-equal to transpose(1, 2).contiguous()")


L2_BYTES = 50 * 2**20  # H100 SXM's L2


def probe_device_ms(fn, x: torch.Tensor, part: str) -> dict:
    """Device ms of the kernel of ``fn(x)`` whose name holds ``part``, by
    ``tools/vi_gram.device_ms`` (each kernel's median duration, a trace
    that lost or repeated calls' events taken again): ``device_ms`` with
    the same ``x`` every call (it stays in L2 after the first), and
    ``device_ms_cold`` with every call on a copy of ``x`` written 100 MB
    before it (so read from device memory).  None, with
    ``device_ms_error``, where no trace was whole."""
    from .vi_gram import device_ms

    kinds = (("probe", part),)
    calls = 2 + 10 * 3  # device_ms's warm-up, first trace, 3 traces of 10
    n = calls + -(-2 * L2_BYTES // x.nbytes)
    copies = x.expand(n, *x.shape).contiguous()
    turn = iter(range(calls))
    try:
        return dict(
            device_ms=device_ms(lambda: fn(x), kinds=kinds)["probe_ms"],
            device_ms_cold=device_ms(lambda: fn(copies[next(turn)]),
                                     kinds=kinds)["probe_ms"])
    except RuntimeError as exc:
        return dict(device_ms=None, device_ms_cold=None,
                    device_ms_error=str(exc))


def time_probe(x: torch.Tensor, reps: int = 50) -> List[dict]:
    """Per variant: kernel ms by CUDA events around ``reps`` calls (the
    wrapper's host work included) and its device ms, warm and cold
    (``probe_device_ms``), the same for the transpose yardstick
    (``library_*``), the plain version's event ms, and the bound (2 × 4 B
    in and out per row, from device memory)."""
    K, _, T = x.shape

    def transpose(t):
        return t.transpose(1, 2).contiguous()

    lib_ms = cuda_ms(lambda: transpose(x), reps)
    lib_dev = probe_device_ms(transpose, x, "")
    plain_ms = cuda_ms(lambda: gram.interleave_probe_reference(x), reps)
    b_ms, b_by = _bound(2 * _nbytes(x), 0)
    rows = []
    for v in gram.PROBE_VARIANTS:
        def run(t):
            return gram.interleave_probe(t, v)

        rows.append(dict(
            variant=v, shape=[K, 2, T], ms=cuda_ms(lambda: run(x), reps),
            **probe_device_ms(run, x, f"interleave_{v}"),
            plain_ms=plain_ms, library_ms=lib_ms,
            **{f"library_{k}": val for k, val in lib_dev.items()},
            bound_ms=b_ms, bound_by=b_by))
    return rows


def main(argv: Sequence[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_sections: no CUDA device", file=sys.stderr)
        return 1
    argv = list(argv)
    mode = "highest"
    if "--mode" in argv:
        i = argv.index("--mode")
        mode = gram.gram_mode(argv[i + 1])
        del argv[i : i + 2]
    T = int(argv[0]) if len(argv) > 0 else 256
    S = int(argv[1]) if len(argv) > 1 else 4
    rank = int(argv[2]) if len(argv) > 2 else 32
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = synthetic_operands(T, S, rank)
    n_rows = ops[0].shape[0] * T
    print(f"device {torch.cuda.get_device_name(0)}; T={T} S={S} "
          f"rank={rank}, {n_rows} rows, Gram mode {mode}", flush=True)
    check_sections(ops, S, mode)
    lib_name = {"highest": "torch.bmm", "bf16": "bf16 torch.bmm",
                "split": "3 bf16 torch.bmm"}[mode]
    for r in time_sections(ops, S, mode=mode):
        lib = ("—" if r["library_ms"] is None
               else f"{r['library_ms']:.3f}")
        print(f"L{r['level']} ({r['what']}): {r['ms']:8.3f} ms "
              f"{r['ns_per_row']:6.3f} ns/row; plain {r['plain_ms']:.1f} ms;"
              f" {lib_name} {lib} ms; bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})", flush=True)
    for shape in ((4, 2, 256), tuple(ops[0].shape)):
        x = torch.randn(shape, device="cuda")
        check_probe(x)
        for r in time_probe(x):
            print(f"probe {r['variant']} {r['shape']}: {r['ms']:.4f} ms; "
                  f"device {r['device_ms']} ms, cold {r['device_ms_cold']}"
                  f" ms; plain {r['plain_ms']:.4f} ms; transpose "
                  f"{r['library_ms']:.4f} ms, device "
                  f"{r['library_device_ms']} ms, cold "
                  f"{r['library_device_ms_cold']} ms; bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
