"""The joint sweep's sequential color tail in one kernel launch.

PyTorch counterpart of ``myfm_tpu/ops/pallas_joint_tail.py``
``joint_tail_pass`` (the Pallas TPU kernel of the joint engine).  After
a block's first few large colors, relational designs with implicit-
feedback columns leave ~1-2k sequential colors of 1-8 features each.
Each color draws its features' (R+1)-dim rows from the carried block
Gram Ĝ and then evolves Ĝ, Atot and Ct — exactly ``_dense_color_apply``
of ops/joint.py, color after color.

``joint_tail_pass`` launches the hand-written CUDA kernel
(csrc/joint_tail.cu) on CUDA tensors and runs the plain PyTorch version
``joint_tail_pass_reference`` on CPU tensors.  Both keep the TPU
package's layouts at the boundary: G as the flat lanes-major [D², B],
Atot [R, B], Ct [B], and the pre-gathered rows u0/lam/mu/xi as
[C, Pf, R+1].  They return (G, Atot, Ct, u_new [C, Pf, R+1]).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .joint import _dense_color_apply


def joint_tail_pass_reference(G, Atot, Ct, xw, segb, u0, lam, mu, xi,
                              alpha, D):
    """Plain PyTorch version: the colors one after another (the scan of
    the TPU package's ops/joint.py:719-728).  Works on any device."""
    u_all = []
    for c in range(xw.shape[0]):
        G, Atot, Ct, u_new = _dense_color_apply(
            G, Atot, Ct, xw[c], segb[c], u0[c], lam[c], mu[c], xi[c],
            alpha, D,
        )
        u_all.append(u_new)
    return G, Atot, Ct, torch.stack(u_all)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib: ctypes.CDLL):
    fn = lib.myfm_joint_tail
    ws = lib.myfm_joint_tail_workspace
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_size_t]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_longlong
    return fn, ws


def _check_cuda(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D):
    if G.device.type != "cuda":
        raise ValueError(
            f"joint_tail_pass: tensors on {G.device} are not supported "
            "(CPU tensors take the plain version)"
        )
    dtype = G.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"joint_tail_pass: dtype {dtype}")
    C, B = xw.shape
    Pf = u0.shape[1]
    R = D - 2
    shapes = {
        "G": (G, (D * D, B)), "Atot": (Atot, (R, B)), "Ct": (Ct, (B,)),
        "xw": (xw, (C, B)), "u0": (u0, (C, Pf, R + 1)),
        "lam": (lam, (C, Pf, R + 1)), "mu": (mu, (C, Pf, R + 1)),
        "xi": (xi, (C, Pf, R + 1)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != G.device:
            raise ValueError(
                f"joint_tail_pass: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, expected {shape} {dtype} on {G.device}"
            )
    if (tuple(segb.shape) != (C, B) or segb.dtype != torch.int32
            or segb.device != G.device):
        raise ValueError(
            f"joint_tail_pass: segb must be int32 [{C}, {B}] on {G.device}"
        )
    return C, B, Pf


def joint_tail_pass(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D):
    """Run every tail color; returns (G, Atot, Ct, u_new).  CPU tensors
    run the plain version; CUDA tensors launch the kernel, or raise.
    ``alpha`` is a scalar tensor (read on the device, no host sync)."""
    if G.device.type == "cpu":
        return joint_tail_pass_reference(G, Atot, Ct, xw, segb, u0, lam,
                                         mu, xi, alpha, D)
    C, B, Pf = _check_cuda(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D)
    dtype = G.dtype
    fn, workspace = _bind(_build.load("joint_tail"))
    is_double = int(dtype == torch.float64)
    # row-major working copies: one block row's D² Gram entries (and its
    # R Atot entries) contiguous, as the kernel reads them
    Gt = G.T.contiguous()
    At = Atot.T.contiguous()
    Ct = Ct.clone()
    u_out = torch.empty_like(u0)
    alpha_t = torch.as_tensor(alpha, dtype=dtype, device=G.device).reshape(1)
    ops = [xw, segb, u0, lam, mu, xi]
    ops = [t.contiguous() for t in ops]
    with torch.cuda.device(G.device):
        # the touched-row lists, plus the per-slot arrays when they do not
        # fit in shared memory (the kernel's own carve-up decides)
        n_ws = workspace(is_double, B, Pf, D)
        if n_ws < 0:
            raise RuntimeError(f"joint_tail kernel: cudaError {-n_ws}")
        ws = torch.empty(n_ws, dtype=torch.uint8, device=G.device)
        rc = fn(
            is_double, _ptr(Gt), _ptr(At), _ptr(Ct),
            *[_ptr(t) for t in ops], _ptr(alpha_t), _ptr(u_out),
            _ptr(ws), n_ws, C, B, Pf, D,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"joint_tail kernel launch failed: cudaError {rc}")
    joint_tail_pass.launches += 1
    # [D², B] and [R, B] as views of the kernel's row-major results: no
    # copy back (the joint sweep reads Atot row-major and drops G)
    return Gt.T, At.T, Ct, u_out

joint_tail_pass.launches = 0
