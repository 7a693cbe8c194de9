"""The yardstick's arithmetic: the card's published peaks, the least time
a kernel call could take, and the model FLOPs of one Gibbs sweep.

The bound of a call is counted from its operands' shapes alone (inputs
read once, outputs written once; every tile row's Gram products counted
once at the fastest arithmetic the Gram modes admit), so it does not
depend on which kernel does the work.  ``bound`` and ``nbytes`` are the
arithmetic of ``chip_smoke.py``'s kernel table.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    to move ``n_bytes`` and do ``flops`` operations at ``flops_per_s``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel1_call(args, kwargs) -> tuple:
    """(bytes, Gram operations) of one Gibbs-layout call of kernel 1,
    ``fused_tile_gram_cross(aux2, gths, wvsl, cont_in, cont_out,
    last_slot, S, carry_in=None, ...)``: the operands read, the partial
    Grams [K*S, D, D] and the carry [D, D] written, and per tile row the
    D(D+1)/2 products of its symmetric Gram, two operations each."""
    aux2, gths, wvsl, cont_in, cont_out, last_slot, S = args[:7]
    K, _, T = aux2.shape
    D = wvsl.shape[2]  # [w | V | qs] per slot: R + 2 = the Gram's width
    item = wvsl.element_size()
    carry = D * D * item
    read = nbytes(aux2, wvsl, cont_in, cont_out, last_slot, *gths)
    if kwargs.get("carry_in") is not None or len(args) > 7:
        read += carry
    written = K * S * D * D * item + carry
    return read + written, K * T * D * (D + 1)


def sweep_flops(rows: int, entities: int, n_tables: int, rank: int,
                scored_rows: int = 0) -> float:
    """Model FLOPs of one fast-path Gibbs sweep: each table's entity
    Grams over every training row (rows × D² × 2, D = rank + 2), the
    entity draws counted as factorisations (entities × D³ / 3), and the
    forward pass over ``scored_rows`` held-out rows (per row each table's
    rank + 1 gathered values summed, then ½(|Q|² − Σ|V|²): about
    (n_tables + 2) × (rank + 1) operations)."""
    D = rank + 2
    return (n_tables * rows * D * D * 2 + entities * D ** 3 / 3
            + scored_rows * (n_tables + 2) * (rank + 1))
