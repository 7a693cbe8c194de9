"""The entity draws of a one-hot table in one kernel launch.

``entity_draws`` launches the hand-written CUDA kernel
(csrc/entity_draws.cu) that draws a table's linear weights and factors
from its per-entity Gram statistics: all of ``_entity_draws`` in
``ops/categorical.py`` (the w0 correction, the linear draw, the
sequential factor scan and, for the sweep's last table, the post-draw
moments), which stays as its plain version: the table pass runs that on
CPU tensors or with ``plain=True``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib: ctypes.CDLL):
    if lib.myfm_entity_draws.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.myfm_entity_draws.argtypes = [i] + [p] * 15 + [i] * 3 + [p]
        lib.myfm_entity_draws.restype = i
    return lib


def _check_scalar(x, name, like: torch.Tensor):
    """``x`` must be one value of ``like``'s dtype on its device (read
    there by the kernel: no host sync)."""
    if (not isinstance(x, torch.Tensor) or x.numel() != 1
            or x.dtype != like.dtype or x.device != like.device):
        raise ValueError(
            f"entity_draws: {name} must be a one-value {like.dtype} tensor "
            f"on {like.device}"
        )


def _check(G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w, lambda_V, mu_V,
           noise_w_t, noise_V_t):
    """(B, R), or raise."""
    dtype = G.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"entity_draws: dtype {dtype}")
    if G.dim() != 3 or G.shape[1] != G.shape[2] or G.shape[1] < 2:
        raise ValueError(f"entity_draws: G is {tuple(G.shape)}, expected "
                         "[B, R + 2, R + 2]")
    B, R = G.shape[0], G.shape[1] - 2
    n_groups = lambda_w.shape[0] if lambda_w.dim() == 1 else -1
    shapes = {
        "G": (G, (B, R + 2, R + 2)), "w_t": (w_t, (B,)), "V_t": (V_t, (B, R)),
        "lambda_w": (lambda_w, (n_groups,)), "mu_w": (mu_w, (n_groups,)),
        "lambda_V": (lambda_V, (n_groups, R)), "mu_V": (mu_V, (n_groups, R)),
        "noise_w": (noise_w_t, (B,)), "noise_V": (noise_V_t, (B, R)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != G.device:
            raise ValueError(
                f"entity_draws: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, expected {shape} {dtype} on {G.device}"
            )
    if not G.is_contiguous():
        raise ValueError("entity_draws: G must be contiguous")
    if (tuple(g_t.shape) != (B,) or g_t.dtype != torch.int64
            or g_t.device != G.device):
        raise ValueError(
            f"entity_draws: g_t must be int64 [{B}] on {G.device}"
        )
    _check_scalar(w0, "w0", G)
    _check_scalar(alpha, "alpha", G)
    if G.device.type != "cuda":
        raise ValueError(
            f"entity_draws: tensors on {G.device} are not supported (CPU "
            "tensors take the plain version)"
        )
    return B, R


def entity_draws(G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w, lambda_V,
                 mu_V, noise_w_t, noise_V_t, cfg, want_moments):
    """``_entity_draws`` in one launch of the kernel on CUDA tensors:
    returns new (w_new [B], V_new [B, R], (Σe, Σe²) or None).  ``G``
    [B, R + 2, R + 2] is the B entities' Grams without w0 (any contiguous
    window of a table's entities), ``g_t`` their int64 group ids; ``w0``
    and ``alpha`` are one-value tensors.  With ``want_moments`` the kernel
    writes each entity's post-draw (Σe, Σe²) and they are added here.
    Raises on any other operand; ``launches`` counts the launches."""
    B, R = _check(G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w, lambda_V,
                  mu_V, noise_w_t, noise_V_t)
    # the kernel reads rows at unit stride: strided operands (w and V are
    # column views of one matrix after an entity+attribute table's pass)
    # are copied, the Grams never
    (w_t, V_t, g_t, lambda_w, mu_w, lambda_V, mu_V, noise_w_t,
     noise_V_t) = (t.contiguous() for t in (
         w_t, V_t, g_t, lambda_w, mu_w, lambda_V, mu_V, noise_w_t,
         noise_V_t))
    w_new = torch.empty_like(w_t)
    V_new = torch.empty_like(V_t)
    moments = G.new_empty((B, 2)) if want_moments else None
    lib = _bind(_build.load("entity_draws"))
    with torch.cuda.device(G.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.myfm_entity_draws(
            int(G.dtype == torch.float64),
            *[_ptr(t) for t in (G, w0, alpha, w_t, V_t, g_t, lambda_w,
                                mu_w, lambda_V, mu_V, noise_w_t, noise_V_t,
                                w_new, V_new)],
            None if moments is None else _ptr(moments),
            B, R, int(bool(cfg.fit_linear)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"entity_draws kernel launch failed: cudaError {rc}")
    entity_draws.launches += 1
    parts = None
    if want_moments:
        parts = (moments[:, 0].sum(), moments[:, 1].sum())
    return w_new, V_new, parts

entity_draws.launches = 0
