"""Per-entity Gram statistics over sorted row tiles.

PyTorch counterpart of the three Pallas TPU kernels of
``myfm_tpu/ops/pallas_gram.py`` and of the two TPU probes of kernel 1
(``scripts/microbench_kernel_sections.py``,
``scripts/probe_transpose.py``):

* ``fused_tile_gram_cross`` (kernel 1), in the Gibbs layout and in the VI
  layout.  The categorical sweeps need, per table and per entity u,

      G_u = Σ_{rows n of u} z_n z_nᵀ,   z_n = [1 | e⁰_n | zcols_n],

  where zcols are the other tables' summed columns (the factor sums φ on
  the Gibbs path; φ, σ, τ on the VI path) and e⁰_n the residual without
  w0.  The kernel takes the other tables' gathered rows as they are and
  sums them itself.
* ``fused_tile_gram`` (kernel 2), the separate-meta variant: the caller
  has already summed the other tables into ``meta`` = [ones | lin−τ(+w0)
  | qs_other] and ``q_other`` (the VI entity+attribute table pass).
* ``tile_gram`` (kernel 3): the Grams of rows the caller has built
  ([K, T, D] z rows and their slots), reached through ``entity_grams``.
* ``gram_section`` (kernel 5): kernel 1 cut down to its first sections,
  levels 0-3, for timing each section (tools/kernel_sections.py).
* ``interleave_probe`` (kernel 6): the load of kernel 1's [K, 2, T]
  (slot, τ) operand into per-row pairs, [K, T, 2].

Rows are sorted by entity and packed into tiles of T rows holding at most
S entities (design_categorical._pack_tiles); an entity that spans tiles
carries its running Gram into slot 0 of the next tile, so its complete
Gram lands at its last (tile, slot).  ``out_rows`` emits only the Gram's
first rows (all D columns): the VI consumers read only the rows
[1 | e | φ].

Each wrapper launches its hand-written CUDA kernel
(csrc/fused_gram_cross.cu; csrc/gram_sections.cu for kernels 5 and 6) on
CUDA tensors and runs its plain PyTorch version on CPU tensors.  Kernels
1-3 run a Gram pass chosen by the Gram's width and mode (``gram_pass``),
then one in-order carry walk (the plain version's ``carry_in_order``).  The
Gram kernels' output is [K*S, rows, D] (the TPU kernel's [K*S, Dpr, D]
without its 8-row slot padding) plus the carry [rows, D] leaving the
last tile, with rows = ``out_rows`` or D.

Kernels 1, 2 and 5 (levels 1-3) take the TPU kernels' Gram arithmetic
mode ``fast_matmul`` (``gram_mode``): "highest" (IEEE), "split" (three
bf16 products of each operand's hi = bf16(x) and lo = bf16(x − hi),
~1.5e-5 of the Gram's scale) or "bf16" (hi·hi alone, ~4e-3); the CUDA
kernels run the two reduced modes on the tensor cores, in fp32 only.
``gram_fast_selfcheck`` validates a mode on the card, as the TPU
package's does on its accelerator.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build

MAX_CROSS = 8
MAX_SLOTS = 64
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block may use
GRAM_MODES = ("highest", "split", "bf16")  # the C side's mode 0, 1, 2


def gram_mode(fast_matmul) -> str:
    """The Gram mode of a ``fast_matmul`` value, normalised as the TPU
    package's kernels do (pallas_gram.py ``_emit_gram_tail``): a string
    names the mode, else True is "split" and False (or None) "highest".
    Raises ValueError for a string that names no mode."""
    mode = (fast_matmul if isinstance(fast_matmul, str)
            else "split" if fast_matmul else "highest")
    if mode not in GRAM_MODES:
        raise ValueError(f"fast_matmul={fast_matmul!r}: not one of "
                         f"{GRAM_MODES}, True or False")
    return mode


def _bf16_split(z: torch.Tensor):
    """(hi, lo) of every value in z's own dtype: hi = bf16(z), lo =
    bf16(z − hi), each rounded to nearest even."""
    hi = z.to(torch.bfloat16).to(z.dtype)
    return hi, (z - hi).to(torch.bfloat16).to(z.dtype)


def _own_rows(wvsl: torch.Tensor, slot: torch.Tensor, S: int):
    """wvsl[k, slot[k, t]] with pad slots (== S) reading a zero row."""
    K = wvsl.shape[0]
    wv_pad = torch.cat([wvsl, wvsl.new_zeros(K, 1, wvsl.shape[2])], dim=1)
    k_idx = torch.arange(K, device=wvsl.device)[:, None]
    return wv_pad[k_idx, slot.clamp(0, S)]


def masked_rows(z: torch.Tensor, m: torch.Tensor, rows: int) -> torch.Tensor:
    """The slot-masked operand [K, T, S*rows]: slot s's block holds the
    first ``rows`` z columns of the rows it weights (m [K, T, S])."""
    K, T, S = m.shape
    return (m[:, :, :, None] * z[:, :, None, :rows]).reshape(K, T, S * rows)


def _masked_gram(z, m, rows, mode="highest"):
    """[K, S*rows, D]: Σ_t m[k,t,s] z zᵀ over the first ``rows`` rows in
    Gram mode ``mode``, as the TPU kernel computes it at any dtype: the
    masked operand A and z split into bf16 hi / lo parts, then A_hi·z_hi
    + A_hi·z_lo + A_lo·z_hi ("split") or A_hi·z_hi ("bf16") in z's dtype.
    m is 0 or 1, so the mask commutes with the split."""
    if mode == "highest":
        return torch.bmm(masked_rows(z, m, rows).transpose(1, 2), z)
    hi, lo = _bf16_split(z)
    a_hi = masked_rows(hi, m, rows).transpose(1, 2)
    out = torch.bmm(a_hi, hi)
    if mode == "split":
        out = out + torch.bmm(a_hi, lo) + torch.bmm(
            masked_rows(lo, m, rows).transpose(1, 2), hi)
    return out


def carry_in_order(partial, cont_in, cont_out, last_slot, carry_in=None):
    """The TPU grid's in-order carry over pass 1's partial Grams
    ``partial`` [K, S, rows, D], in place: in tile order, ``partial[k, 0]
    += carry`` where cont_in[k], then ``carry = partial[k, last_slot[k]]``
    where cont_out[k]; tiles with neither flag set neither read nor change
    it.  ``carry_in`` None is a zero carry.  Returns the carry leaving the
    last tile."""
    carry = (partial.new_zeros(partial.shape[2:]) if carry_in is None
             else carry_in.clone())
    ci = cont_in.tolist()
    co = cont_out.tolist()
    ls = last_slot.tolist()
    for k in range(partial.shape[0]):
        if ci[k]:
            partial[k, 0] += carry
        if co[k]:
            carry = partial[k, ls[k]].clone()
    return carry


def _grams_with_carry(z, m, rows, cont_in, cont_out, last_slot, carry_in,
                      mode="highest"):
    """Σ_t m[k,t,s] z zᵀ over the first ``rows`` rows (in Gram mode
    ``mode``), then ``carry_in_order``.  Returns (flat [K*S, rows, D],
    carry_out [rows, D])."""
    K, T, S = m.shape
    D = z.shape[2]
    partial = _masked_gram(z, m, rows, mode).reshape(K, S, rows, D)
    carry = carry_in_order(partial, cont_in, cont_out, last_slot, carry_in)
    return partial.reshape(K * S, rows, D), carry


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ_r x[..., r]² over the last axis in order r = 0, 1, ..., each
    product and sum rounded on its own: the kernels' order and rounding
    (csrc/gram_tile.cuh add_sq), so a z row's e is the same bit for bit
    on both sides and the reduced Gram modes round it alike."""
    s = torch.zeros_like(x[..., 0])
    for r in range(x.shape[-1]):
        s = s + x[..., r] * x[..., r]
    return s


def cross_rows(aux2, gths, wvsl, S: int, q_lo: int = 1, n_extra: int = 0):
    """Kernel 1's z rows [K, T, D] and slot mask m [K, T, S] (plain
    PyTorch).  The gathered rows have W = q_lo + R + n_extra + 1 columns
    [lin | .. | zcols | qs] with the zcols block (R own-factor columns,
    then ``n_extra`` more) starting at ``q_lo``; D = R + n_extra + 2."""
    slot_f = aux2[:, 0, :]
    tau = aux2[:, 1, :]
    K, T = slot_f.shape
    R = wvsl.shape[2] - 2
    n_z = R + n_extra
    qs_col = q_lo + n_z
    dtype = wvsl.dtype
    slot = slot_f.long()
    valid = (slot >= 0) & (slot < S)
    ones = valid.to(dtype)
    lin_o = torch.zeros(K, T, dtype=dtype, device=wvsl.device)
    qs_o = torch.zeros(K, T, dtype=dtype, device=wvsl.device)
    Z_o = torch.zeros(K, T, n_z, dtype=dtype, device=wvsl.device)
    for gth in gths:
        lin_o = lin_o + gth[:, :, 0]
        Z_o = Z_o + gth[:, :, q_lo : q_lo + n_z]
        qs_o = qs_o + gth[:, :, qs_col]
    own = _own_rows(wvsl, torch.where(valid, slot, S), S)
    qf = Z_o[:, :, :R] + own[:, :, 1 : 1 + R]
    score = (
        lin_o
        - tau
        + own[:, :, 0]
        + 0.5 * (_sum_sq(qf) - qs_o - own[:, :, 1 + R])
    )
    e = score * ones
    z = torch.cat([ones[:, :, None], e[:, :, None], Z_o], dim=2)
    m = (
        slot[:, :, None] == torch.arange(S, device=slot.device)
    ).to(dtype)  # [K, T, S], all-zero on pad rows
    return z, m


def fused_tile_gram_cross_reference(
    aux2: torch.Tensor,  # [K, 2, T] (slot_f, tau); pad rows slot_f == S
    gths: Sequence[torch.Tensor],  # n_cross × [K, T, W] gathered rows
    wvsl: torch.Tensor,  # [K, S, 2+R] own [w | V | qs] per slot
    cont_in: torch.Tensor,  # [K] int32
    cont_out: torch.Tensor,  # [K] int32
    last_slot: torch.Tensor,  # [K] int32
    S: int,
    carry_in: Optional[torch.Tensor] = None,  # [rows, D]
    q_lo: int = 1,
    n_extra: int = 0,
    out_rows: Optional[int] = None,
    fast_matmul=False,
):
    """Plain PyTorch version of kernel 1: returns (flat partial Grams
    [K*S, rows, D], carry_out [rows, D]); layout as in ``cross_rows``,
    Gram mode as ``gram_mode(fast_matmul)``.  Works on any device (the
    comparisons on the card run it on CUDA tensors)."""
    z, m = cross_rows(aux2, gths, wvsl, S, q_lo, n_extra)
    rows = z.shape[2] if out_rows is None else out_rows
    return _grams_with_carry(z, m, rows, cont_in, cont_out, last_slot,
                             carry_in, gram_mode(fast_matmul))


def meta_rows(meta, q_other, slot, wvsl, S: int):
    """Kernel 2's z rows [K, T, D] and row-weighted slot mask m
    [K, T, S] (plain PyTorch).  ``q_other``'s first R columns (R = wvsl
    width − 1) are the other tables' factor sums φ; the rest enter z as
    they are; D = Rq + 2."""
    R = wvsl.shape[2] - 1
    ones = meta[:, :, 0]
    m = (
        slot.long()[:, :, None] == torch.arange(S, device=slot.device)
    ).to(meta.dtype) * ones[:, :, None]
    own = torch.bmm(m, wvsl)  # [K, T, 1+R]
    qf = q_other[:, :, :R] + own[:, :, 1:]
    score = meta[:, :, 1] + own[:, :, 0] + 0.5 * (
        _sum_sq(qf) - meta[:, :, 2] - _sum_sq(own[:, :, 1:])
    )
    e = score * ones
    z = torch.cat([ones[:, :, None], e[:, :, None], q_other], dim=2)
    return z, m


def fused_tile_gram_reference(
    meta: torch.Tensor,  # [K, T, 3] [ones | lin−τ(+w0) | qs_other]
    q_other: torch.Tensor,  # [K, T, Rq]
    slot: torch.Tensor,  # [K, T] int32
    wvsl: torch.Tensor,  # [K, S, 1+R] own [w | V] per slot
    cont_in: torch.Tensor,
    cont_out: torch.Tensor,
    last_slot: torch.Tensor,
    S: int,
    carry_in: Optional[torch.Tensor] = None,  # [rows, D]
    out_rows: Optional[int] = None,
    fast_matmul=False,
):
    """Plain PyTorch version of kernel 2 (the TPU package's
    ``fused_tile_gram_reference`` with the ``out_rows`` rectangle and
    the kernel's Gram modes): returns (flat partial Grams [K*S, rows,
    D], carry_out [rows, D]); layout as in ``meta_rows``."""
    z, m = meta_rows(meta, q_other, slot, wvsl, S)
    rows = z.shape[2] if out_rows is None else out_rows
    return _grams_with_carry(z, m, rows, cont_in, cont_out, last_slot,
                             carry_in, gram_mode(fast_matmul))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib: ctypes.CDLL):
    if lib.myfm_fused_gram_cross.argtypes is None:
        lib.myfm_tile_gram.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        lib.myfm_tile_gram.restype = ctypes.c_int
        lib.myfm_fused_gram_cross.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int]
            + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p]
        )
        lib.myfm_fused_gram_cross.restype = ctypes.c_int
        lib.myfm_fused_gram.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        lib.myfm_fused_gram.restype = ctypes.c_int
        for fn in ("myfm_gram_carry_scratch", "myfm_gram_carry_sync"):
            getattr(lib, fn).argtypes = [ctypes.c_int] * 2
            getattr(lib, fn).restype = ctypes.c_int
        lib.myfm_gram_ring_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.myfm_gram_ring_bytes.restype = ctypes.c_int
        lib.myfm_gram_pass.argtypes = [ctypes.c_int] * 3
        lib.myfm_gram_pass.restype = ctypes.c_int
        lib.myfm_gram_static_smem.argtypes = []
        lib.myfm_gram_static_smem.restype = ctypes.c_int
    return lib


# The Gram passes of a pass-1 launch (csrc/gram_tile.cuh gram_pass_id):
# IEEE FMA, the mma.sync tensor-core pass, the wgmma pass (the fp32 square
# at D >= WGMMA_MIN_D in "split" and "bf16").
GRAM_PASSES = ("fma", "mma", "wgmma")
WGMMA_MIN_D = 64
# z rows of the wgmma pass's stage chunk and bf16 ring(s), by mode
RING_ROWS = {"split": 64, "bf16": 128}


def gram_pass(mode: str, D: int, rows: int) -> str:
    """The Gram pass the card runs for a [rows, D] Gram in Gram mode
    ``mode``: the C launcher's choice (``myfm_gram_pass``, which the card
    tests hold this to)."""
    if mode == "highest":
        return "fma"
    return "wgmma" if rows == D and D >= WGMMA_MIN_D else "mma"


def _card_pass(mode: str, D: int, rows: int) -> str:
    """The Gram pass the C launcher takes for a [rows, D] Gram in Gram
    mode ``mode`` (``myfm_gram_pass``, the rule its launch follows): what
    the wrappers' ``pass_launches`` count after a launch (``gram_pass``
    is its mirror, for sizing the stage before one)."""
    lib = _bind(_build.load("fused_gram_cross"))
    return GRAM_PASSES[lib.myfm_gram_pass(GRAM_MODES.index(mode), D, rows)]


def _stage_bytes(pass_name, mode, T, width, D, item, head=0):
    """Dynamic shared memory of a pass-1 stage of T rows of ``width``
    values: the whole tile, or for the wgmma pass one chunk of at most
    RING_ROWS[mode] rows (``head`` more values per row) behind the bf16
    ring (two rings, hi and lo, in "split"; ``myfm_gram_ring_bytes``)."""
    if pass_name != "wgmma":
        return T * width * item
    rows = RING_ROWS[mode]
    ring = -(-D // 8) * 8 * rows * 2 * (2 if mode == "split" else 1)
    return ring + min(T, rows) * (width + head) * item


def _check_common(name, floats, ints, K, S, rows, D, carry_in, smem):
    """Device, dtype, contiguity, flag and shared-memory checks shared by
    the Gram wrappers (``smem``: the bytes of the dynamic stage); raises
    on what the kernel does not take."""
    device = floats[0].device
    dtype = floats[0].dtype
    if device.type != "cuda":
        raise ValueError(
            f"{name}: tensors on {device} are not supported (CPU tensors "
            "take the plain version)"
        )
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype}")
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"{name}: S={S} (max {MAX_SLOTS})")
    if not 1 <= rows <= D:
        raise ValueError(f"{name}: out_rows={rows} outside [1, {D}]")
    for t in floats + ([carry_in] if carry_in is not None else []):
        if t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: operands must share dtype and device ({t.dtype} "
                f"on {t.device} vs {dtype} on {device})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous operand")
    for t, shape in ints:
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: index operands must be contiguous int32 {shape} "
                f"on {device}"
            )
    if carry_in is not None and tuple(carry_in.shape) != (rows, D):
        raise ValueError(f"{name}: carry_in {tuple(carry_in.shape)} != "
                         f"{(rows, D)}")
    # the Gram pass's run list, on top of the dynamic stage
    smem += _bind(_build.load("fused_gram_cross")).myfm_gram_static_smem()
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: needs {smem} B of shared memory per tile (limit "
            f"{SMEM_LIMIT}); use smaller tiles"
        )


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _card_mode(name, mode, dtype) -> int:
    """The C side's mode number of ``mode``; raises ValueError for a
    reduced mode outside fp32 (the card has no fp64 tensor-core path, and
    falling back to IEEE would hide it)."""
    if mode != "highest" and dtype != torch.float32:
        raise ValueError(f"{name}: Gram mode {mode!r} needs float32, got "
                         f"{dtype}")
    return GRAM_MODES.index(mode)


def _launch(name, fn, operands, dims, K, S, rows, D, dtype, device,
            carry_in, lib=None, lead=None):
    """Allocate the outputs and the carry walk's workspace, call the C
    entry point ``fn`` (its ``lead`` integers, by default the dtype flag;
    its operand pointers; then carry_in / out / carry_out / scratch /
    sync; then its integer ``dims``) on the current stream, and raise if
    the launch failed."""
    lib = lib or _bind(_build.load("fused_gram_cross"))
    scratch_lib = _bind(_build.load("fused_gram_cross"))
    if carry_in is None:
        carry_in = torch.zeros(rows, D, dtype=dtype, device=device)
    out = torch.empty(K * S, rows, D, dtype=dtype, device=device)
    carry_out = torch.empty(rows, D, dtype=dtype, device=device)
    is_double = int(dtype == torch.float64)
    scratch = torch.empty(
        scratch_lib.myfm_gram_carry_scratch(K, rows * D),
        dtype=dtype, device=device)
    sync = torch.zeros(
        scratch_lib.myfm_gram_carry_sync(K, rows * D),
        dtype=torch.int32, device=device)
    if lead is None:
        lead = [is_double]
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(
            *lead, *operands, _ptr(carry_in), _ptr(out), _ptr(carry_out),
            _ptr(scratch), _ptr(sync), *dims, _stream(),
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out, carry_out


def fused_tile_gram_cross(
    aux2: torch.Tensor,
    gths: Sequence[torch.Tensor],
    wvsl: torch.Tensor,
    cont_in: torch.Tensor,
    cont_out: torch.Tensor,
    last_slot: torch.Tensor,
    S: int,
    carry_in: Optional[torch.Tensor] = None,
    q_lo: int = 1,
    n_extra: int = 0,
    out_rows: Optional[int] = None,
    fast_matmul=False,
):
    """Kernel 1: flat partial Grams [K*S, rows, D] and the carry leaving
    the last tile (layout as in ``fused_tile_gram_cross_reference``; the
    defaults are the Gibbs layout with the full square Gram) in Gram mode
    ``gram_mode(fast_matmul)``.  ``e`` excludes w0: the consumers apply
    the exact rank-1 w0 correction to the Gram statistics.  CPU tensors
    run the plain version; CUDA tensors launch the kernel, or raise.
    ``launches`` counts the Gibbs-layout launches, ``vi_launches`` all
    others, ``mode_launches[layout][mode]`` both by mode ("gibbs" /
    "vi"), and ``pass_launches[pass]`` all by the Gram pass that ran
    (``gram_pass``: "fma", "mma", "wgmma")."""
    gths = tuple(gths)
    mode = gram_mode(fast_matmul)
    if aux2.device.type == "cpu":
        return fused_tile_gram_cross_reference(
            aux2, gths, wvsl, cont_in, cont_out, last_slot, S, carry_in,
            q_lo, n_extra, out_rows, mode,
        )
    K, two, T = aux2.shape
    R = wvsl.shape[2] - 2
    D = R + n_extra + 2
    W = q_lo + R + n_extra + 1
    rows = D if out_rows is None else out_rows
    name = "fused_tile_gram_cross"
    if two != 2 or tuple(wvsl.shape[:2]) != (K, S) or R < 0:
        raise ValueError(f"{name}: aux2 {tuple(aux2.shape)}, wvsl "
                         f"{tuple(wvsl.shape)}, S={S}")
    if q_lo < 1 or n_extra < 0 or len(gths) > MAX_CROSS:
        raise ValueError(f"{name}: q_lo={q_lo}, n_extra={n_extra}, "
                         f"{len(gths)} cross tables (max {MAX_CROSS})")
    for gth in gths:
        if tuple(gth.shape) != (K, T, W):
            raise ValueError(f"{name}: gathered rows {tuple(gth.shape)} "
                             f"!= {(K, T, W)}")
    item = wvsl.element_size()
    code = _card_mode(name, mode, wvsl.dtype)
    pass_name = gram_pass(mode, D, rows)
    _check_common(
        name, [aux2, wvsl, *gths],
        [(t, (K,)) for t in (cont_in, cont_out, last_slot)],
        K, S, rows, D, carry_in,
        _stage_bytes(pass_name, mode, T, W, D, item, head=2)
        + S * (R + 2) * item + T * 4,
    )
    gth_ptrs = (ctypes.c_void_p * max(len(gths), 1))(
        *[g.data_ptr() for g in gths]
    )
    out = _launch(
        name, "myfm_fused_gram_cross",
        [_ptr(aux2), ctypes.cast(gth_ptrs, ctypes.c_void_p), len(gths),
         _ptr(wvsl), _ptr(cont_in), _ptr(cont_out), _ptr(last_slot)],
        [K, T, S, R, q_lo, n_extra, rows],
        K, S, rows, D, wvsl.dtype, wvsl.device, carry_in,
        lead=[int(wvsl.dtype == torch.float64), code],
    )
    layout = "gibbs" if (q_lo, n_extra, out_rows) == (1, 0, None) else "vi"
    if layout == "gibbs":
        fused_tile_gram_cross.launches += 1
    else:
        fused_tile_gram_cross.vi_launches += 1
    fused_tile_gram_cross.mode_launches[layout][mode] += 1
    fused_tile_gram_cross.pass_launches[_card_pass(mode, D, rows)] += 1
    return out


def mode_counts():
    """A fresh per-mode launch count."""
    return dict.fromkeys(GRAM_MODES, 0)


def pass_counts():
    """A fresh per-pass launch count."""
    return dict.fromkeys(GRAM_PASSES, 0)


fused_tile_gram_cross.launches = 0
fused_tile_gram_cross.vi_launches = 0
fused_tile_gram_cross.mode_launches = {"gibbs": mode_counts(),
                                       "vi": mode_counts()}
fused_tile_gram_cross.pass_launches = pass_counts()


def fused_tile_gram(
    meta: torch.Tensor,
    q_other: torch.Tensor,
    slot: torch.Tensor,
    wvsl: torch.Tensor,
    cont_in: torch.Tensor,
    cont_out: torch.Tensor,
    last_slot: torch.Tensor,
    S: int,
    carry_in: Optional[torch.Tensor] = None,
    out_rows: Optional[int] = None,
    fast_matmul=False,
):
    """Kernel 2: flat partial Grams [K*S, rows, D] and the carry leaving
    the last tile (layout as in ``fused_tile_gram_reference``; ``ones``,
    meta's first column, is 0 or 1) in Gram mode
    ``gram_mode(fast_matmul)``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel, or raise.  ``launches`` counts the
    launches, ``mode_launches[mode]`` them by mode, ``pass_launches``
    by Gram pass (as kernel 1's)."""
    mode = gram_mode(fast_matmul)
    if meta.device.type == "cpu":
        return fused_tile_gram_reference(
            meta, q_other, slot, wvsl, cont_in, cont_out, last_slot, S,
            carry_in, out_rows, mode,
        )
    K, T, Rq = q_other.shape
    R = wvsl.shape[2] - 1
    D = Rq + 2
    rows = D if out_rows is None else out_rows
    name = "fused_tile_gram"
    if (tuple(meta.shape) != (K, T, 3) or tuple(wvsl.shape[:2]) != (K, S)
            or not 0 <= R <= Rq):
        raise ValueError(f"{name}: meta {tuple(meta.shape)}, q_other "
                         f"{tuple(q_other.shape)}, wvsl "
                         f"{tuple(wvsl.shape)}, S={S}")
    item = wvsl.element_size()
    code = _card_mode(name, mode, wvsl.dtype)
    pass_name = gram_pass(mode, D, rows)
    _check_common(
        name, [meta, q_other, wvsl],
        [(slot, (K, T))] + [(t, (K,)) for t in (cont_in, cont_out,
                                                last_slot)],
        K, S, rows, D, carry_in,
        _stage_bytes(pass_name, mode, T, D, D, item) + S * (R + 1) * item
        + T * 4,
    )
    out = _launch(
        name, "myfm_fused_gram",
        [_ptr(meta), _ptr(q_other), _ptr(slot), _ptr(wvsl), _ptr(cont_in),
         _ptr(cont_out), _ptr(last_slot)],
        [K, T, S, R, Rq, rows],
        K, S, rows, D, wvsl.dtype, wvsl.device, carry_in,
        lead=[int(wvsl.dtype == torch.float64), code],
    )
    fused_tile_gram.launches += 1
    fused_tile_gram.mode_launches[mode] += 1
    fused_tile_gram.pass_launches[_card_pass(mode, D, rows)] += 1
    return out


fused_tile_gram.launches = 0
fused_tile_gram.mode_launches = mode_counts()
fused_tile_gram.pass_launches = pass_counts()


# The self-check's gates: the largest |mode − IEEE| over the IEEE Gram's
# largest entry (the TPU package's: an order of magnitude above each
# mode's ~1.5e-5 / ~4e-3).
SELFCHECK_TOL = {"split": 2e-4, "bf16": 2e-2}
_selfcheck_cache: dict = {}


def gram_fast_selfcheck(mode: str = "split", device="cuda") -> bool:
    """Whether Gram mode ``mode`` ("split" or "bf16") holds on the card
    ``device``: kernel 2 in that mode against kernel 2 in IEEE on one
    small random problem (the TPU package's, ``pallas_gram.py``
    ``gram_fast_selfcheck``: RandomState(3), K = 4, T = 256, S = 4,
    R = 32), every entry within ``SELFCHECK_TOL[mode]`` of the IEEE
    Gram's largest.  Cached per (device, mode); False off CUDA, as the
    TPU package's is off its accelerator.  A failed build or launch
    raises: only a failed numerical check returns False."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), mode)
    hit = _selfcheck_cache.get(key)
    if hit is not None:
        return hit
    tol = SELFCHECK_TOL[mode]
    rng = np.random.RandomState(3)
    K, T, S, R = 4, 256, 4, 32
    meta = rng.normal(size=(K, T, 3)).astype(np.float32)
    meta[:, :, 0] = 1.0
    q = (rng.normal(size=(K, T, R)) * 0.3).astype(np.float32)
    slot = rng.randint(0, S, (K, T)).astype(np.int32)
    slot.sort(axis=1)
    wvsl = (rng.normal(size=(K, S, 1 + R)) * 0.3).astype(np.float32)
    flags = (np.zeros(K, np.int32), np.zeros(K, np.int32),
             np.full(K, S - 1, np.int32))
    args = [torch.as_tensor(a, device=device)
            for a in (meta, q, slot, wvsl, *flags)]
    ieee, _ = fused_tile_gram(*args, S)
    fast, _ = fused_tile_gram(*args, S, fast_matmul=mode)
    scale = float(ieee.abs().max())
    ok = float((fast - ieee).abs().max()) <= tol * scale
    _selfcheck_cache[key] = ok
    return ok


def tile_gram_reference(
    rows: torch.Tensor,  # [K, T, D] tile rows (pad rows are zero rows)
    slot: torch.Tensor,  # [K, T] int32 slot per row
    cont_in: torch.Tensor,  # [K] int32
    cont_out: torch.Tensor,  # [K] int32
    last_slot: torch.Tensor,  # [K] int32
    S: int,
    carry_in: Optional[torch.Tensor] = None,  # [D, D]; None = zero
):
    """Plain PyTorch version of kernel 3: (flat partial Grams [K*S, D, D],
    carry_out [D, D]) of the given rows, with the in-order carry."""
    m = (
        slot.long()[:, :, None] == torch.arange(S, device=slot.device)
    ).to(rows.dtype)
    return _grams_with_carry(rows, m, rows.shape[2], cont_in, cont_out,
                             last_slot, carry_in)


def tile_gram(
    rows: torch.Tensor,
    slot: torch.Tensor,
    cont_in: torch.Tensor,
    cont_out: torch.Tensor,
    last_slot: torch.Tensor,
    S: int,
    carry_in: Optional[torch.Tensor] = None,
):
    """Kernel 3: flat partial Grams [K*S, D, D] of the given rows and the
    carry leaving the last tile (``carry_in`` None is a zero carry).  CPU
    tensors run the plain version; CUDA tensors launch the kernel, or
    raise.  ``launches`` counts the launches, ``pass_launches`` them by
    Gram pass (IEEE only: "fma")."""
    if rows.device.type == "cpu":
        return tile_gram_reference(rows, slot, cont_in, cont_out, last_slot,
                                   S, carry_in)
    K, T, D = rows.shape
    _check_common(
        "tile_gram", [rows],
        [(slot, (K, T))] + [(t, (K,)) for t in (cont_in, cont_out,
                                                last_slot)],
        K, S, D, D, carry_in, T * D * rows.element_size() + T * 4,
    )
    out = _launch(
        "tile_gram", "myfm_tile_gram",
        [_ptr(rows), _ptr(slot), _ptr(cont_in), _ptr(cont_out),
         _ptr(last_slot)],
        [K, T, S, D], K, S, D, D, rows.dtype, rows.device, carry_in,
    )
    tile_gram.launches += 1
    tile_gram.pass_launches[_card_pass("highest", D, D)] += 1
    return out


tile_gram.launches = 0
tile_gram.pass_launches = pass_counts()


def entity_grams(table, rows_tiled: torch.Tensor, S: int, D: int,
                 plain: bool = False) -> torch.Tensor:
    """All-entity Grams [B, D, D] of a CategoricalTable's tile rows
    ``rows_tiled`` [K, T, D] in one call: kernel 3 (its plain version with
    ``plain``), then each entity's complete Gram at its last (tile,
    slot)."""
    slot = table.slot.reshape(rows_tiled.shape[:2])
    gram = tile_gram_reference if plain else tile_gram
    flat, _ = gram(rows_tiled, slot, table.cont_in, table.cont_out,
                   table.last_slot, S)
    return flat[table.final_part.long()]


# ---- kernel 5: kernel 1 section by section (Gibbs layout, fp32) ----

SECTION_LEVELS = (0, 1, 2, 3)


def _section_mode(level: int, fast_matmul) -> str:
    if level not in SECTION_LEVELS:
        raise ValueError(f"gram_section: level {level} not in "
                         f"{SECTION_LEVELS}")
    mode = gram_mode(fast_matmul)
    if level == 0 and mode != "highest":
        raise ValueError("gram_section: level 0 (the checksum) has no "
                         f"Gram mode, got {mode!r}")
    return mode


def gram_section_reference(level: int, aux2, gths, wvsl, cont_in, cont_out,
                           last_slot, S: int, fast_matmul=False):
    """Plain PyTorch version of section level ``level`` (csrc/
    gram_sections.cu) in Gram mode ``gram_mode(fast_matmul)`` (levels
    1-3): (out [K*S, D, D], carry_out or None).  Levels 0 and 1 define
    their output by a per-tile checksum of every operand; level 2 is
    kernel 1 without the carry, level 3 kernel 1 whole."""
    mode = _section_mode(level, fast_matmul)
    if level == 3:
        return fused_tile_gram_cross_reference(
            aux2, gths, wvsl, cont_in, cont_out, last_slot, S,
            fast_matmul=mode)
    K, _, T = aux2.shape
    R = wvsl.shape[2] - 2
    D = R + 2
    if level == 2:
        z, m = cross_rows(aux2, gths, wvsl, S)
        return _grams_with_carry(z, m, D, cont_in.new_zeros(K),
                                 cont_out.new_zeros(K), last_slot, None,
                                 mode)[0], None
    total = sum(g.sum(dim=(1, 2)) for g in gths) \
        + wvsl.sum(dim=(1, 2)) + aux2.sum(dim=(1, 2))
    if level == 0:
        return total[:, None, None, None].expand(K, S, D, D).reshape(
            K * S, D, D).clone(), None
    slot = aux2[:, 0, :].long()
    m = (slot[:, :, None] == torch.arange(S, device=slot.device)).to(
        wvsl.dtype)
    out = _grams_with_carry(gths[0], m, D, cont_in.new_zeros(K),
                            cont_out.new_zeros(K), last_slot, None, mode)[0]
    out = out.reshape(K, S, D, D)
    out[:, 0, 0, 0] += total
    return out.reshape(K * S, D, D), None


def _bind_sections(lib: ctypes.CDLL):
    if lib.myfm_gram_section.argtypes is None:
        lib.myfm_gram_section.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int]
            + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.myfm_gram_section.restype = ctypes.c_int
        lib.myfm_interleave_probe.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
        )
        lib.myfm_interleave_probe.restype = ctypes.c_int
    return lib


def gram_section(level: int, aux2, gths, wvsl, cont_in, cont_out,
                 last_slot, S: int, fast_matmul=False):
    """Kernel 5: section level ``level`` of kernel 1 on kernel 1's
    operands (Gibbs layout, fp32; layout as in
    ``gram_section_reference``) in Gram mode ``gram_mode(fast_matmul)``
    (levels 1-3; level 0 has none).  Level 3's output is bit-equal to
    ``fused_tile_gram_cross`` on the same operands in the same mode.  CPU
    tensors run the plain version; CUDA tensors launch the kernel, or
    raise.  ``launches[level]`` counts the launches per level,
    ``mode_launches[mode][level]`` by mode too."""
    mode = _section_mode(level, fast_matmul)
    gths = tuple(gths)
    if aux2.device.type == "cpu":
        return gram_section_reference(level, aux2, gths, wvsl, cont_in,
                                      cont_out, last_slot, S, mode)
    K, two, T = aux2.shape
    R = wvsl.shape[2] - 2
    D = R + 2
    name = f"gram_section[{level}]"
    if wvsl.dtype != torch.float32:
        raise TypeError(f"{name}: fp32 only, got {wvsl.dtype}")
    if (two != 2 or tuple(wvsl.shape[:2]) != (K, S) or not gths
            or len(gths) > MAX_CROSS):
        raise ValueError(f"{name}: aux2 {tuple(aux2.shape)}, wvsl "
                         f"{tuple(wvsl.shape)}, {len(gths)} cross tables")
    for gth in gths:
        if tuple(gth.shape) != (K, T, D):
            raise ValueError(f"{name}: gathered rows {tuple(gth.shape)} "
                             f"!= {(K, T, D)}")
    _check_common(
        name, [aux2, wvsl, *gths],
        [(t, (K,)) for t in (cont_in, cont_out, last_slot)],
        K, S, D, D, None, (T * D + S * D + T) * 4 + T * 4,
    )
    gth_ptrs = (ctypes.c_void_p * len(gths))(*[g.data_ptr() for g in gths])
    out, carry = _launch(
        name, "myfm_gram_section",
        [_ptr(aux2), ctypes.cast(gth_ptrs, ctypes.c_void_p), len(gths),
         _ptr(wvsl), _ptr(cont_in), _ptr(cont_out), _ptr(last_slot)],
        [K, T, S, R], K, S, D, D, wvsl.dtype, wvsl.device, None,
        lib=_bind_sections(_build.load("gram_sections")),
        lead=[level, GRAM_MODES.index(mode)],
    )
    gram_section.launches[level] += 1
    gram_section.mode_launches[mode][level] += 1
    return out, (carry if level == 3 else None)


def section_counts():
    """A fresh per-mode, per-level launch count."""
    return {m: [0] * len(SECTION_LEVELS) for m in GRAM_MODES}


gram_section.launches = [0] * len(SECTION_LEVELS)  # per level
gram_section.mode_launches = section_counts()


# ---- kernel 6: the (slot, τ) load of kernel 1 ----

PROBE_VARIANTS = ("direct", "staged")


def interleave_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: [K, 2, T] -> [K, T, 2] pairs."""
    return torch.stack([x[:, 0, :], x[:, 1, :]], dim=2)


def interleave_probe(x: torch.Tensor, variant: str = "direct"):
    """Kernel 6: kernel 1's [K, 2, T] (slot, τ) rows as per-row pairs
    [K, T, 2], by one 8-byte store per row ("direct") or staged through
    shared memory ("staged").  CPU tensors run the plain version; CUDA
    tensors launch the kernel, or raise."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"interleave_probe: variant {variant!r}")
    if x.device.type == "cpu":
        return interleave_probe_reference(x)
    K, two, T = x.shape
    if (x.dtype != torch.float32 or two != 2 or not x.is_contiguous()
            or not 1 <= K <= 65535):
        raise ValueError(f"interleave_probe: contiguous fp32 [K, 2, T] "
                         f"with K <= 65535, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty(K, T, 2, dtype=x.dtype, device=x.device)
    lib = _bind_sections(_build.load("gram_sections"))
    with torch.cuda.device(x.device):
        rc = lib.myfm_interleave_probe(PROBE_VARIANTS.index(variant),
                                       _ptr(x), _ptr(out), K, T, _stream())
    if rc != 0:
        raise RuntimeError(f"interleave_probe kernel launch failed: "
                           f"cudaError {rc}")
    interleave_probe.launches[variant] += 1
    return out


interleave_probe.launches = dict.fromkeys(PROBE_VARIANTS, 0)
