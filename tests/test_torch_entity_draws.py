"""The entity-draws kernel (csrc/entity_draws.cu, ops/entity_draws.py)
against its plain PyTorch version ``ops/categorical._entity_draws``.

Tests marked ``cuda`` run on the card and skip without one; the file
imports neither JAX nor the TPU package, so on a machine with only
PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_entity_draws.py

The others run on the CPU: there the table pass takes the plain version
and never the kernel, and the wrapper refuses what the kernel does not
take.  Tolerances, as a share of the plain draws' largest magnitude (at
least 1): 1e-4 in float32, as the other card tests (the kernel adds each
factor's correction in factor order, the plain version 8 factors at a
time), and 1e-10 in float64.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from myfm_tpu_torch import MyFMGibbsRegressor, RelationBlock
from myfm_tpu_torch.design_categorical import try_compile_categorical
from myfm_tpu_torch.ops import categorical as cat
from myfm_tpu_torch.ops.entity_draws import entity_draws
from myfm_tpu_torch.ops.gibbs import GibbsConfig

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# operand order of entity_draws after G and w0
NAMES = ("w_t", "V_t", "g_t", "alpha", "lambda_w", "mu_w", "lambda_V",
         "mu_V", "noise_w", "noise_V")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(B, R, dtype, device, n_groups=3, seed=0, rows=6):
    """Draw operands: each entity's G a real Gram of ``rows`` rows
    z = [1 | e | phi], the hyperparameters of ``n_groups`` groups."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(B, rows, R + 2))
    z[:, :, 0] = 1.0
    G = np.einsum("bni,bnj->bij", z, z)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(
        G=t(G), w0=t(np.array(0.3)), w_t=t(rng.normal(size=B)),
        V_t=t(rng.normal(size=(B, R))),
        g_t=torch.as_tensor(rng.randint(0, n_groups, B), device=device),
        alpha=t(np.array(1.7)),
        lambda_w=t(rng.random(n_groups) + 0.5),
        mu_w=t(0.1 * rng.normal(size=n_groups)),
        lambda_V=t(rng.random((n_groups, R)) + 0.5),
        mu_V=t(0.1 * rng.normal(size=(n_groups, R))),
        noise_w=t(rng.normal(size=B)), noise_V=t(rng.normal(size=(B, R))),
    )


def _cfg(fit_linear):
    return GibbsConfig(task="regression", fit_linear=fit_linear)


def _kernel(ops, fit_linear, want_moments=False):
    return entity_draws(ops["G"], ops["w0"], *[ops[k] for k in NAMES],
                        _cfg(fit_linear), want_moments)


def _plain(ops, fit_linear, want_moments=False):
    return cat._entity_draws(ops["G"], ops["w0"], *[ops[k] for k in NAMES],
                             _cfg(fit_linear), want_moments)


def _assert_close(got, want, dtype, what):
    """(w, V) and, where both have them, the moments (Σe, Σe²), each
    within tolerance of the plain value's scale."""
    got_m, want_m = got[2], want[2]
    assert (got_m is None) == (want_m is None), what
    pairs = [("w", got[0], want[0]), ("V", got[1], want[1])]
    if want_m is not None:
        pairs += [("sum_e", got_m[0], want_m[0]),
                  ("sum_e2", got_m[1], want_m[1])]
    for name, x, r in pairs:
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1.0)
        err = float((x - r).abs().max()) if r.numel() else 0.0
        assert err <= TOL[dtype] * scale, (what, name, err, scale)


# ---- on the card --------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("fit_linear", [True, False])
@pytest.mark.parametrize("R", [0, 1, 7, 8, 9, 32, 33, 128, 130, 300])
def test_kernel_matches_plain(R, fit_linear, B, dtype):
    """Every rank the lanes' panels meet (1, 2 and 4 factors a lane, one
    panel and several), with and without the linear draw, one entity and
    a count that leaves a block part-filled; the moments of the draws."""
    ops = _operands(B, R, dtype, _cuda(), seed=R + B)
    before = entity_draws.launches
    got = _kernel(ops, fit_linear, want_moments=True)
    assert entity_draws.launches == before + 1
    _assert_close(got, _plain(ops, fit_linear, True), dtype,
                  (R, fit_linear, B))
    without = _kernel(ops, fit_linear)
    assert without[2] is None
    assert torch.equal(without[0], got[0]) and torch.equal(without[1], got[1])
    if not fit_linear:
        assert torch.equal(got[0], ops["w_t"])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [32, 128])
def test_window_of_grams_draws_the_same_entities(R):
    """A contiguous window of the Grams, as the reduce-scatter path passes
    its rank's share: the window's draws are the whole table's, bit for
    bit, and the plain version's within tolerance."""
    ops = _operands(64, R, torch.float32, _cuda(), seed=R)
    w_all, V_all, _ = _kernel(ops, True)
    lo, hi = 16, 48
    win = {k: (v[lo:hi] if k in ("G", "w_t", "V_t", "g_t", "noise_w",
                                 "noise_V") else v)
           for k, v in ops.items()}
    assert win["G"].is_contiguous()
    got = _kernel(win, True, want_moments=True)
    assert torch.equal(got[0], w_all[lo:hi])
    assert torch.equal(got[1], V_all[lo:hi])
    _assert_close(got, _plain(win, True, True), torch.float32, "window")


@pytest.mark.cuda
def test_strided_weights_draw_as_contiguous_ones():
    """w and V as column views of one [B, 1 + R] matrix, as an
    entity+attribute table's pass leaves them for the next table: the
    same bits as their contiguous copies."""
    ops = _operands(37, 33, torch.float32, _cuda(), seed=2)
    U = torch.cat([ops["w_t"][:, None], ops["V_t"]], dim=1)
    strided = dict(ops, w_t=U[:, 0], V_t=U[:, 1:])
    assert not strided["w_t"].is_contiguous()
    assert not strided["V_t"].is_contiguous()
    a = _kernel(strided, True, want_moments=True)
    b = _kernel(ops, True, want_moments=True)
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_same_operands_give_the_same_bits():
    ops = _operands(300, 128, torch.float32, _cuda(), seed=5)
    a = _kernel(ops, True, want_moments=True)
    b = _kernel(ops, True, want_moments=True)
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["mixed_dtype", "shape", "noncontiguous_G",
                                 "group_dtype", "alpha_dtype"])
def test_wrapper_raises_on_card(bad):
    """Each fault raises on the card before any launch."""
    _bad_call(bad, _cuda())


def _design(seed=4, n=5000, n_u=80, n_i=50):
    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, n_u, n), rng.randint(0, n_i, n)
    z = rng.normal(size=n_u)[u] + rng.normal(size=n_i)[i]
    blocks = [RelationBlock(u, sps.identity(n_u, format="csr")),
              RelationBlock(i, sps.identity(n_i, format="csr"))]
    return blocks, z + 0.3 * rng.normal(size=n)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("rank", [8, 33])
def test_sweep_with_draws_kernel_matches_plain(task, rank):
    """One fast-path sweep on a real plan through the kernels (kernel 1
    and the entity draws, one launch a table) vs one through their plain
    versions, same state and variates, float64."""
    from myfm_tpu_torch.ops.categorical import (
        categorical_sweep,
        draw_sweep_variates,
    )
    from myfm_tpu_torch.trainer import CategoricalGibbsTrainer

    device = _cuda()
    blocks, z = _design()
    y = np.where(z > 0, 1.0, -1.0) if task == "classification" else z
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   device, rank=rank)
    tr = CategoricalGibbsTrainer(plan, y, GibbsConfig(task=task), rank, 0.1,
                                 0, np.float64)
    st = tr._initialize()
    v = draw_sweep_variates(plan, tr.cfg, rank, tr.generator, torch.float64,
                            device)
    before = entity_draws.launches
    a = categorical_sweep(plan, st, tr.y, tr.y_tiles, v, tr.cfg)
    assert entity_draws.launches == before + len(plan.tables)
    b = categorical_sweep(plan, st, tr.y, tr.y_tiles, v, tr.cfg, plain=True)
    assert entity_draws.launches == before + len(plan.tables)
    for f in ("w", "V", "e", "w0", "alpha"):
        x, r = getattr(a.core, f), getattr(b.core, f)
        assert float((x - r).abs().max()) <= 1e-8 * max(
            float(r.abs().max()), 1.0), f
    for x, r in ((a.sum_e, b.sum_e), (a.sum_e2, b.sum_e2)):
        assert abs(float(x) - float(r)) <= 1e-8 * max(abs(float(r)), 1.0)


@pytest.mark.cuda
def test_fit_launches_once_per_table_and_sweep():
    """The estimator's fast path draws each table in one launch a sweep."""
    device = _cuda()
    blocks, y = _design(n=3000, n_u=60, n_i=40)
    n_iter = 5
    before = entity_draws.launches
    fm = MyFMGibbsRegressor(rank=16, random_seed=3, device=device).fit(
        None, y, X_rel=blocks, n_iter=n_iter, n_kept_samples=n_iter)
    assert fm.history_.engine == "fastpath"
    assert entity_draws.launches - before == len(blocks) * n_iter


# ---- on the CPU ---------------------------------------------------------


# each fault, and the message of the check that must refuse it
FAULTS = {
    "mixed_dtype": ("V_t", lambda a: a.double(), "V_t is"),
    "shape": ("noise_V", lambda a: a[:, :4].contiguous(), "noise_V is"),
    "noncontiguous_G": ("G", lambda a: a.transpose(1, 2), "G must"),
    "group_dtype": ("g_t", lambda a: a.int(), "g_t must"),
    "alpha_dtype": ("alpha", lambda a: a.double(), "alpha must"),
}


def _bad_call(bad, device):
    ops = _operands(9, 5, torch.float32, device)
    name, fault, message = FAULTS[bad]
    ops[name] = fault(ops[name])
    before = entity_draws.launches
    with pytest.raises(ValueError, match=message):
        _kernel(ops, True)
    assert entity_draws.launches == before


@pytest.mark.parametrize("bad", ["mixed_dtype", "shape", "noncontiguous_G",
                                 "group_dtype", "alpha_dtype"])
def test_wrapper_checks_operands(bad):
    """Each fault is refused by its own check, ahead of the device's."""
    _bad_call(bad, "cpu")


def test_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: CPU tensors take the plain version
    in the table pass, never a fallback inside the wrapper."""
    with pytest.raises(ValueError, match="plain version"):
        _kernel(_operands(9, 5, torch.float64, "cpu"), True)


@pytest.mark.parametrize("want_moments", [True, False])
@pytest.mark.parametrize("fit_linear", [True, False])
def test_table_pass_on_cpu_runs_the_plain_draws(fit_linear, want_moments,
                                                monkeypatch):
    """On CPU tensors the table pass draws through ``_entity_draws`` with
    or without ``plain``, the kernel's wrapper untouched: the same bits
    both ways, and the launch counter stays where it was."""
    blocks, y = _design(n=600, n_u=31, n_i=19)
    R = 3
    plan = try_compile_categorical(None, blocks, None, None, np.float64,
                                   "cpu", rank=R)
    rng = np.random.RandomState(2)
    F, G_n = plan.n_features, plan.n_groups

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    args = (t(rng.normal(size=F)), t(rng.normal(size=(F, R))), t(0.4),
            t(1.7), t(rng.random(G_n) + 0.5), t(0.1 * rng.normal(size=G_n)),
            t(rng.random((G_n, R)) + 0.5),
            t(0.1 * rng.normal(size=(G_n, R))), plan.group_index,
            t(rng.normal(size=F)), t(rng.normal(size=(F, R))))
    tau = cat.make_y_tiles(plan, t(y))
    cfg = GibbsConfig(task="regression", fit_linear=fit_linear)
    calls = []
    monkeypatch.setattr(cat, "entity_draws",
                        lambda *a: calls.append(a) or entity_draws(*a))
    before = entity_draws.launches
    for ti in range(len(plan.tables)):
        out = [cat._table_pass(plan, ti, *args, tau[ti], cfg, plain=plain,
                               want_moments=want_moments)
               for plain in (False, True)]
        (wa, Va, ma), (wb, Vb, mb) = out
        assert torch.equal(wa, wb) and torch.equal(Va, Vb)
        if want_moments:
            assert all(torch.equal(x, z) for x, z in zip(ma, mb))
        else:
            assert ma is None and mb is None
    assert calls == [] and entity_draws.launches == before
