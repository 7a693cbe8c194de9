"""The joint sweep's sequential color tail in one kernel launch.

PyTorch counterpart of ``myfm_tpu/ops/pallas_joint_tail.py``
``joint_tail_pass`` (the Pallas TPU kernel of the joint engine).  After
a block's first few large colors, relational designs with implicit-
feedback columns leave ~1-2k sequential colors of 1-8 features each.
Each color draws its features' (R+1)-dim rows from the carried block
Gram Ĝ and then evolves Ĝ, Atot and Ct — exactly ``_dense_color_apply``
of ops/joint.py, color after color.

``joint_tail_pass`` launches the hand-written CUDA kernels
(csrc/joint_tail.cu: the prep kernel that builds every color's lists,
then the chain) on CUDA tensors and runs the plain PyTorch version
``joint_tail_pass_reference`` on CPU tensors.  ``tail_lists`` is the
prep kernel's lists alone, beside their plain version
``tail_lists_reference``.  Both keep the TPU
package's layouts at the boundary: G as the flat lanes-major [D², B],
Atot [R, B], Ct [B], and the pre-gathered rows u0/lam/mu/xi as
[C, Pf, R+1].  They return (G, Atot, Ct, u_new [C, Pf, R+1]).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

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


def tail_lists_reference(segb, Pf):
    """Plain version of the prep kernel's lists for segb [C, B]:
    (rows [C, B]: each color's touched rows (0 <= segb < Pf) grouped by
    slot, in row order inside a slot, then -1; lstart [C, Pf + 1]: the
    row start of each live slot (a slot owning rows), then the count n of
    touched rows; live [C, Pf + 1]: the live slot ids ascending, then -1,
    and the count of live slots at [:, Pf]).  int32."""
    C, B = segb.shape
    s = segb.long()
    ok = (s >= 0) & (s < Pf)
    key = torch.where(ok, s, Pf)
    order = torch.sort(key, dim=1, stable=True).indices
    n = ok.sum(dim=1)
    place = torch.arange(B, device=segb.device)
    rows = torch.where(place[None] < n[:, None], order, -1)
    counts = nnf.one_hot(key, Pf + 1)[..., :Pf].sum(dim=1)  # [C, Pf]
    starts = counts.cumsum(dim=1) - counts
    alive = counts > 0
    ids = torch.sort(torch.where(
        alive, torch.arange(Pf, device=segb.device), Pf), dim=1).values
    has = ids < Pf
    nl = alive.sum(dim=1, keepdim=True)
    live = torch.cat([torch.where(has, ids, -1), nl], dim=1)
    at = torch.gather(starts, 1, ids.clamp(max=Pf - 1))
    lstart = torch.cat([torch.where(has, at, n[:, None]), n[:, None]],
                       dim=1)
    return rows.int(), lstart.int(), live.int()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib: ctypes.CDLL):
    if lib.myfm_joint_tail_chain.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.myfm_joint_tail_workspace.argtypes = [i] * 5
        lib.myfm_joint_tail_workspace.restype = ctypes.c_longlong
        lib.myfm_joint_tail_lists_layout.argtypes = [i] * 3 + [p]
        lib.myfm_joint_tail_lists_layout.restype = None
        lib.myfm_joint_tail_prep.argtypes = (
            [i] + [p] * 9 + [ctypes.c_size_t] + [i] * 4 + [p])
        lib.myfm_joint_tail_prep.restype = i
        lib.myfm_joint_tail_chain.argtypes = (
            [i] + [p] * 6 + [ctypes.c_size_t] + [i] * 4 + [p, p])
        lib.myfm_joint_tail_chain.restype = i
    return lib


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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


def _prep(lib, xw, segb, u0, lam, mu, xi, alpha_t, u_out, D):
    """The prep kernel into a new workspace (sized for the chain too);
    returns it."""
    C, B = xw.shape
    Pf = u0.shape[1]
    is_double = int(xw.dtype == torch.float64)
    n_ws = lib.myfm_joint_tail_workspace(is_double, C, B, Pf, D)
    if n_ws < 0:
        raise RuntimeError(f"joint_tail kernel: cudaError {-n_ws}")
    ws = torch.empty(n_ws, dtype=torch.uint8, device=xw.device)
    ops = [t.contiguous() for t in (segb, xw, u0, lam, mu, xi)]
    rc = lib.myfm_joint_tail_prep(
        is_double, *[_ptr(t) for t in ops], _ptr(alpha_t), _ptr(u_out),
        _ptr(ws), n_ws, C, B, Pf, D, _stream())
    if rc != 0:
        raise RuntimeError(f"joint_tail prep kernel failed: cudaError {rc}")
    tail_lists.launches += 1
    return ws


def tail_lists(segb, Pf):
    """The prep kernel's lists for segb [C, B] (int32), as
    ``tail_lists_reference`` states them.  CPU tensors run the plain
    version; CUDA tensors launch the prep kernel, or raise."""
    if segb.device.type == "cpu":
        return tail_lists_reference(segb, Pf)
    if segb.device.type != "cuda" or segb.dtype != torch.int32:
        raise ValueError("tail_lists: segb must be int32 on a CUDA device")
    C, B = segb.shape
    D = 3  # the lists do not depend on the operands' width
    z = torch.zeros((C, Pf, D - 1), device=segb.device)
    lib = _bind(_build.load("joint_tail"))
    with torch.cuda.device(segb.device):
        ws = _prep(lib, segb.new_zeros(segb.shape, dtype=torch.float32),
                   segb, z, z, z, z, torch.ones(1, device=segb.device),
                   torch.empty_like(z), D)
    lay = (ctypes.c_longlong * 5)()
    lib.myfm_joint_tail_lists_layout(C, B, Pf, lay)

    def view(at, width, keep):
        return ws[at: at + C * width * 4].view(torch.int32).reshape(
            C, width)[:, :keep]

    return (view(lay[0], lay[3], B), view(lay[1], lay[4], Pf + 1),
            view(lay[2], lay[4], Pf + 1))

tail_lists.launches = 0


def _launch(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D, clk=None):
    """The prep kernel, then the chain (from the timed build when
    ``clk``, an int64 CUDA tensor of a count per phase and sub-phase, is
    given); returns (G, Atot, Ct, u_new)."""
    C, B, Pf = _check_cuda(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D)
    dtype = G.dtype
    lib = _bind(_build.load("joint_tail" if clk is None
                            else "joint_tail_timed"))
    is_double = int(dtype == torch.float64)
    # row-major working copies: one block row's D² Gram entries (and its
    # R Atot entries) contiguous, as the kernel reads them
    Gt = G.T.contiguous()
    At = Atot.T.contiguous()
    Ct = Ct.clone()
    u_out = torch.empty_like(u0)
    alpha_t = torch.as_tensor(alpha, dtype=dtype, device=G.device).reshape(1)
    with torch.cuda.device(G.device):
        ws = _prep(lib, xw, segb, u0, lam, mu, xi, alpha_t, u_out, D)
        rc = lib.myfm_joint_tail_chain(
            is_double, _ptr(Gt), _ptr(At), _ptr(Ct), _ptr(alpha_t),
            _ptr(u_out), _ptr(ws), ws.numel(), C, B, Pf, D, _stream(),
            None if clk is None else _ptr(clk))
    if rc != 0:
        raise RuntimeError(f"joint_tail kernel launch failed: cudaError {rc}")
    # [D², B] and [R, B] as views of the kernel's row-major results: no
    # copy back (the joint sweep reads Atot row-major and drops G)
    return Gt.T, At.T, Ct, u_out


def joint_tail_pass(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D):
    """Run every tail color; returns (G, Atot, Ct, u_new).  CPU tensors
    run the plain version; CUDA tensors launch the kernels, or raise.
    ``alpha`` is a scalar tensor (read on the device, no host sync)."""
    if G.device.type == "cpu":
        return joint_tail_pass_reference(G, Atot, Ct, xw, segb, u0, lam,
                                         mu, xi, alpha, D)
    out = _launch(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D)
    joint_tail_pass.launches += 1
    return out

joint_tail_pass.launches = 0

PHASES = ("stage", "stats", "draw", "update")
# thread 0's own path inside the draw and the update (its slot's draw,
# its rows), not part of the phases' sum
SUB_PHASES = ("draw.assemble", "draw.factor", "draw.solve",
              "update.load_gs", "update.reduce_pr", "update.write")


def joint_tail_phases(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D):
    """The chain's timed instantiation (the library "joint_tail_timed",
    built at its first call), for measurement tools only (its launches
    are not counted): ((G, Atot, Ct, u_new), cycles), where cycles
    [len(PHASES) + len(SUB_PHASES)] (int64, CPU) are the clock64() cycles
    that the chain's first thread spent in each phase, summed over the
    colors, then in each of SUB_PHASES."""
    clk = torch.zeros(len(PHASES) + len(SUB_PHASES), dtype=torch.int64,
                      device=G.device)
    out = _launch(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D, clk)
    return out, clk.cpu()
