"""Training loops driving the categorical, joint and colored Gibbs sweeps.

PyTorch counterpart of ``myfm_tpu/trainer.py`` (``run_mcmc_loop``,
``GibbsTrainer``, ``CategoricalGibbsTrainer``, ``LazyFMView``, the
pipelined harvest ``_HostCopy`` (the TPU package's ``_snap``) /
``_AsyncDrain`` / ``LazyHyper`` / ``_LazyAccept`` / ``LazyPackedFM``,
``callback_allows_async``, and
``_resolve_joint_tail`` in place of ``_resolve_joint_pallas_tail``):
runs ``n_iter`` sweeps, keeps the last ``n_kept_samples`` weight samples
(with their cutpoints, for the ordered task) on the host, records the
hyperparameter trace (and the MH accept counts) every iteration,
invokes the callback with early-stop support, and checkpoints the chain
every N sweeps (checkpoint.py).

When the callback allows it, the trace and the kept samples are
harvested without stalling the chain: each sweep's values are cloned on
the compute stream and copied to pinned host memory on a side stream,
and the loop waits for a copy only ``_SNAP_LAG`` sweeps later.  A user
callback gets host values every sweep.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .containers import FM, FMHyperParameters, LearningHistory
from .design_categorical import torch_dtype
from .ops.categorical import (
    categorical_sweep,
    draw_sweep_variates,
    init_categorical_state,
    make_y_tiles,
)
from .ops.forward import predict_score
from .ops.gram import gram_fast_selfcheck, gram_mode
from .ops.gibbs import (
    TASK_ORDERED,
    GibbsConfig,
    GibbsState,
    check_task,
    draw_gibbs_variates,
    gibbs_sweep,
    init_state,
)
from .ops.oprobit import initialize_oprobit_core
from .ops.special import uniform_open
from .parallel.collectives import local_rows
from .predictor import Predictor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _split_cutpoints(cat: np.ndarray, groups) -> list:
    """The concatenated cutpoint vector split into one vector per
    cutpoint group, as the FM container holds them."""
    groups = groups or (cat.shape[0] + 1,)
    out, off = [], 0
    for K in groups:
        out.append(cat[off : off + K - 1])
        off += K - 1
    return out


class LazyFMView(FM):
    """FM view over device state; copies arrays to the host only on
    access.  ``cut_groups`` (the class count per cutpoint group) splits
    the concatenated cutpoints."""

    def __init__(self, state: GibbsState, cut_groups=()):
        self._state = state
        self._cut_groups = cut_groups
        self._w0 = None
        self._w = None
        self._V = None
        self._cutpoints = None

    @property
    def w0(self):  # type: ignore[override]
        if self._w0 is None:
            self._w0 = float(self._state.w0)
        return self._w0

    @property
    def w(self):  # type: ignore[override]
        if self._w is None:
            self._w = _host(self._state.w)
        return self._w

    @property
    def V(self):  # type: ignore[override]
        if self._V is None:
            self._V = _host(self._state.V)
        return self._V

    @property
    def cutpoints(self):  # type: ignore[override]
        if self._cutpoints is None:
            cat = self._state.cutpoints
            self._cutpoints = (
                [] if cat is None
                else _split_cutpoints(_host(cat), self._cut_groups)
            )
        return self._cutpoints

    def materialize(self) -> FM:
        return FM(self.w0, self.w, self.V, self.cutpoints)


def callback_allows_async(callback) -> bool:
    """True when the trace may be harvested asynchronously: no
    callback, or one tagged ``allow_async_trace`` (the progress-bar
    wrapper in base._fit).  User callbacks get host values every
    sweep."""
    return callback is None or bool(
        getattr(callback, "allow_async_trace", False)
    )


# sweeps a harvested copy may stay in flight before the loop waits on it
_SNAP_LAG = 3

_copy_streams = {}


def _copy_stream(device: torch.device):
    """The side stream that copies snapshots to the host, one per
    device."""
    stream = _copy_streams.get(device)
    if stream is None:
        stream = _copy_streams[device] = torch.cuda.Stream(device)
    return stream


def _count_sync():
    run_mcmc_loop.host_syncs += 1


class _HostCopy:
    """Host copy of a tuple of device tensors, started at once.

    On a CUDA device the tensors are cloned on the compute stream (a
    snapshot no later sweep can touch) and copied into pinned host
    buffers on a side stream that waits on the compute stream; an event
    marks the copies' end.  Each snapshot is recorded on the side
    stream, so the caching allocator does not reuse its memory before
    the copy has read it.  ``wait`` copies the pinned buffers into
    ordinary host memory and releases them, so the host allocator
    reuses about ``_SNAP_LAG + 1`` sweeps' worth of them however many
    samples the chain keeps.  On the CPU the copy is made at once."""

    __slots__ = ("_host", "_event")

    # pinned bytes of the copies not yet waited on, and their peak
    pinned_bytes = 0
    peak_pinned_bytes = 0

    def __init__(self, tensors):
        tensors = [t.detach() for t in tensors]
        self._event = None
        if not tensors or tensors[0].device.type != "cuda":
            self._host = tuple(t.clone().numpy() for t in tensors)
            return
        device = tensors[0].device
        snaps = [t.clone() for t in tensors]
        stream = _copy_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in snaps)
            for h, t in zip(host, snaps):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        self._host = host
        _HostCopy.pinned_bytes += sum(h.nbytes for h in host)
        _HostCopy.peak_pinned_bytes = max(_HostCopy.peak_pinned_bytes,
                                          _HostCopy.pinned_bytes)

    def wait(self):
        """The host arrays, once their copies are done (a copy still in
        flight counts as one of the loop's host syncs)."""
        if self._event is not None:
            if not self._event.query():
                _count_sync()
                self._event.synchronize()
            self._event = None
            _HostCopy.pinned_bytes -= sum(h.nbytes for h in self._host)
            self._host = tuple(h.numpy().copy() for h in self._host)
        return self._host


class _AsyncDrain:
    """Pending harvests in sweep order: ``push`` adds one and forces
    those older than ``lag`` sweeps, ``drain`` forces the rest."""

    def __init__(self, lag: int = _SNAP_LAG):
        self.lag = lag
        self._pending = deque()

    def push(self, obj, sweep: int) -> None:
        self._pending.append((sweep, obj))
        while self._pending and self._pending[0][0] <= sweep - self.lag:
            self._pending.popleft()[1].force()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft()[1].force()


class LazyHyper:
    """Hyper-trace entry backed by a harvest (alpha, mu_w, lambda_w,
    mu_V, lambda_V[, n_mh_accept]); duck-types FMHyperParameters and
    reads its values on first access."""

    __slots__ = ("_bufs", "_vals", "_nacc")

    def __init__(self, bufs: _HostCopy, has_accept: bool = False):
        self._bufs = bufs
        self._vals = None
        self._nacc = () if has_accept else None

    def force(self) -> FMHyperParameters:
        if self._vals is None:
            vals = self._bufs.wait()
            a, mu_w, lam_w, mu_V, lam_V = vals[:5]
            self._vals = FMHyperParameters(
                alpha=float(a), mu_w=mu_w, lambda_w=lam_w, mu_V=mu_V,
                lambda_V=lam_V,
            )
            if self._nacc is not None:
                self._nacc = vals[5].tolist()
            self._bufs = None
        return self._vals

    materialize = force

    def accept_counts(self):
        self.force()
        return self._nacc

    @property
    def alpha(self):
        return self.force().alpha

    @property
    def mu_w(self):
        return self.force().mu_w

    @property
    def lambda_w(self):
        return self.force().lambda_w

    @property
    def mu_V(self):
        return self.force().mu_V

    @property
    def lambda_V(self):
        return self.force().lambda_V


class _LazyAccept:
    """Per-sweep n_mh_accept_trace entry: a view of its LazyHyper."""

    __slots__ = ("_hyper",)

    def __init__(self, hyper: LazyHyper):
        self._hyper = hyper

    def materialize(self):
        return self._hyper.accept_counts()


class LazyPackedFM:
    """Kept sample backed by a harvest (w0, w, V[, cutpoints]),
    materialized into an FM after the loop."""

    __slots__ = ("_bufs", "_vals", "_cut_groups")

    def __init__(self, bufs: _HostCopy, cut_groups=()):
        self._bufs = bufs
        self._vals = None
        self._cut_groups = cut_groups

    def force(self) -> FM:
        if self._vals is None:
            vals = self._bufs.wait()
            w0, w, V = vals[:3]
            cuts = (_split_cutpoints(vals[3], self._cut_groups)
                    if len(vals) > 3 else [])
            self._vals = FM(float(w0), w, V, cuts)
            self._bufs = None
        return self._vals

    materialize = force


def _read(t: torch.Tensor) -> np.ndarray:
    """One of the eager harvest's host reads (a host sync each)."""
    _count_sync()
    return _host(t)


def _eager_hyper(core: GibbsState) -> FMHyperParameters:
    return FMHyperParameters(
        alpha=float(_read(core.alpha)),
        mu_w=_read(core.mu_w),
        lambda_w=_read(core.lambda_w),
        mu_V=_read(core.mu_V),
        lambda_V=_read(core.lambda_V),
    )


def _eager_sample(core: GibbsState, cut_groups) -> FM:
    cuts = core.cutpoints
    return FM(float(_read(core.w0)), _read(core.w), _read(core.V),
              [] if cuts is None
              else _split_cutpoints(_read(cuts), cut_groups))


def run_mcmc_loop(
    trainer,
    n_iter: int,
    n_kept_samples: int,
    callback=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    core_of=lambda s: s,
) -> Tuple[Predictor, LearningHistory]:
    """Shared MCMC driver: runs the chain, keeps the last
    ``n_kept_samples`` weight samples, records the hyper trace, invokes
    the callback with early stop, and with ``checkpoint_path`` and
    ``checkpoint_every`` writes the chain state and the generator's
    state every N sweeps.  ``resume=True`` continues from the checkpoint
    at ``checkpoint_path`` (when it exists) and reproduces the chain an
    uninterrupted run would have drawn: the trainer initializes as that
    run did, then takes the saved state and generator state.

    ``trainer`` provides ``_initialize()``, ``_sweep_call(state)``,
    ``generator`` and the ``rank / n_features / cfg / dtype / device /
    engine_name`` attributes; ``core_of`` maps its state to the
    GibbsState.

    Harvest: the pipelined one (``_HostCopy``, ``_AsyncDrain``) where
    ``callback_allows_async(callback)``, else host values every sweep.
    Afterwards every entry is a plain FM / FMHyperParameters / list, so
    the predictor and the history pickle.  ``run_mcmc_loop.host_syncs``
    counts the loop's waits on the device (one per eager sweep read, one
    per harvest still in flight when forced)."""
    from .checkpoint import load_checkpoint, save_checkpoint

    generators = (trainer.generator,)
    state = trainer._initialize()
    start_it = 0
    # a sharded chain's checkpoint holds every rank's rows (checkpoint.py)
    axis, plan = trainer.cfg.axis, trainer.plan
    rows = (plan.row_lo, plan.row_lo + plan.n_rows)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, start_it = load_checkpoint(
            checkpoint_path, state, generators,
            rows=None if axis is None else rows)
    predictor = Predictor(
        trainer.rank, trainer.n_features, trainer.cfg.task,
        trainer.dtype, trainer.device,
    )
    history = LearningHistory(
        engine=trainer.engine_name,
        gram_fast_matmul=trainer.cfg.gram_fast_matmul)
    ordered = trainer.cfg.task == TASK_ORDERED
    cut_groups = trainer.cfg.cutpoint_group_classes
    drain = _AsyncDrain() if callback_allows_async(callback) else None
    for it in range(start_it, n_iter):
        state = trainer._sweep_call(state)
        core = core_of(state)
        view = LazyFMView(core, cut_groups)
        keep = it + n_kept_samples >= n_iter
        if drain is not None:
            fields = [core.alpha, core.mu_w, core.lambda_w, core.mu_V,
                      core.lambda_V]
            if ordered:
                fields.append(core.n_mh_accept)
            hyper = LazyHyper(_HostCopy(fields), has_accept=ordered)
            drain.push(hyper, it)
            if ordered:
                history.n_mh_accept_trace.append(_LazyAccept(hyper))
            if keep:
                fields = [core.w0, core.w, core.V]
                if core.cutpoints is not None:
                    fields.append(core.cutpoints)
                sample = LazyPackedFM(_HostCopy(fields), cut_groups)
                predictor.samples.append(sample)
                drain.push(sample, it)
        else:
            if keep:
                predictor.samples.append(_eager_sample(core, cut_groups))
            hyper = _eager_hyper(core)
            if ordered:
                # cumulative accept count per cutpoint group, every sweep
                history.n_mh_accept_trace.append(
                    _read(core.n_mh_accept).tolist())
        history.hypers.append(hyper)
        if callback is not None and callback(it, view, hyper, history):
            break
        if checkpoint_path and checkpoint_every and (
                (it + 1) % checkpoint_every == 0):
            save_checkpoint(checkpoint_path, state, it + 1, generators,
                            axis=axis, n_total=plan.n_real)
    if drain is not None:
        drain.drain()
        history.hypers = [h.materialize() for h in history.hypers]
        history.n_mh_accept_trace = [
            a.materialize() for a in history.n_mh_accept_trace]
        predictor.samples = [s.materialize() for s in predictor.samples]
    if ordered:
        history.n_mh_accept = [
            int(c) for c in _host(core_of(state).n_mh_accept)
        ]
    return predictor, history


run_mcmc_loop.host_syncs = 0


def _resolve_gram_fast_matmul(cfg, dtype, device, rank=None):
    """Resolve the fast path's Gram mode ``cfg.gram_fast_matmul`` (the
    TPU package's ``_resolve_gram_fast_matmul``, with a CUDA device in
    place of its TPU backend).  None (auto), float32 on a CUDA device,
    after the per-mode self-checks on that card
    (ops/gram.gram_fast_selfcheck):

    - Gibbs at rank >= 64 (``rank`` given): "bf16", the single-pass
      product (~4e-3 relative, orders below a Gibbs draw's noise);
    - otherwise "split", the 3-pass bf16 split (~1.5e-5 relative), also
      for the deterministic VI paths (``rank`` None);
    - a mode whose self-check fails is not taken (False: IEEE).

    Everything else (the CPU, float64) resolves to False.  An explicit
    value is kept, True as "split"; a mode other than False with float64
    on CUDA raises ValueError: there is no fp64 tensor-core path, and
    IEEE in its place would hide that."""
    mode = cfg.gram_fast_matmul
    cuda = torch.device(device).type == "cuda"
    f32 = np.dtype(dtype) == np.float32
    if mode is None:
        use = False
        if f32 and cuda:
            if rank is not None and rank >= 64 and gram_fast_selfcheck(
                    "bf16", device):
                use = "bf16"
            elif gram_fast_selfcheck("split", device):
                use = "split"
        return dataclasses.replace(cfg, gram_fast_matmul=use)
    if mode is not False:
        mode = gram_mode(mode)
        if cuda and not f32 and mode != "highest":
            raise ValueError(
                f"gram_fast_matmul={cfg.gram_fast_matmul!r} needs float32 "
                f"on a CUDA device, got {np.dtype(dtype).name}")
    return dataclasses.replace(cfg, gram_fast_matmul=mode)


# The TPU package's gate on its tail kernel (trainer.py
# _resolve_joint_pallas_tail): beyond D = 34 (rank 32) the plain loop.
JOINT_TAIL_MAX_D = 34


def _resolve_joint_tail(cfg: GibbsConfig, plan, rank: int) -> GibbsConfig:
    """Resolve ``joint_tail_kernel``:

    - None (auto): the CUDA kernel when the plan lives on a CUDA device
      and D = rank + 2 <= JOINT_TAIL_MAX_D; otherwise the plain loop;
    - True: the kernel; raises for a plan on the CPU;
    - False: the plain loop.

    Nothing self-checks and silently falls back: the card tests and
    chip_smoke.py hold the kernel against its plain version."""
    if cfg.joint_tail_kernel is None:
        use = (plan.device.type == "cuda"
               and rank + 2 <= JOINT_TAIL_MAX_D)
        return dataclasses.replace(cfg, joint_tail_kernel=use)
    if cfg.joint_tail_kernel is True and plan.device.type != "cuda":
        raise ValueError(
            "joint_tail_kernel=True launches a CUDA kernel but the plan is "
            f"on {plan.device}; use joint_tail_kernel=False (the plain "
            "loop) there."
        )
    return cfg


def _target(y, cfg: GibbsConfig, dtype, plan) -> torch.Tensor:
    """The chain's target on the plan's device: the encoded integer
    classes for the ordered task, else y in the chain's dtype (±1 for
    classification); a sharded plan's own rows of it.  Validates the
    task."""
    check_task(cfg)
    y = np.asarray(y)
    if plan.n_total is not None:
        y = y[plan.row_lo : plan.row_lo + plan.n_rows]
    if cfg.task == TASK_ORDERED:
        return torch.as_tensor(y.astype(np.int64), device=plan.device)
    return torch.as_tensor(y.astype(dtype), device=plan.device)


def _init_uniforms(trainer) -> torch.Tensor:
    """The ordered task's initial latent uniforms, from the chain's
    generator after the weights' own draws: drawn for the whole design,
    a sharded plan keeping its own rows."""
    plan = trainer.plan
    return local_rows(
        uniform_open((plan.n_real,), trainer.generator, trainer._tdtype,
                     trainer.device), plan.row_lo, plan.n_rows)


class GibbsTrainer:
    """Gibbs trainer on a compiled row-space design (design.DesignPlan):
    the joint engine (``cfg.joint_rows``: merged (w, V) rows, or factor
    rows alone without the linear terms) or the colored engine.  Runs on
    the plan's device; one ``torch.Generator`` seeded with
    ``random_seed`` drives the chain."""

    def __init__(
        self,
        plan,  # DesignPlan
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        self.plan = plan
        # as in the TPU package, only the joint engine resolves its tail
        # (which sweep_V_joint, without linear terms, never launches)
        self.cfg = (_resolve_joint_tail(cfg, plan, rank) if cfg.joint_rows
                    else cfg)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = _target(y, cfg, self.dtype, plan)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(random_seed)

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "joint" if self.cfg.joint_rows else "colored"

    def _sweep_call(self, state: GibbsState) -> GibbsState:
        variates = draw_gibbs_variates(
            self.plan, self.cfg, self.rank, self.generator, self._tdtype,
            self.device,
        )
        return gibbs_sweep(self.plan, state, self.y, variates, self.cfg)

    def _initialize(self) -> GibbsState:
        state = init_state(
            self.plan, self.rank, self.init_stdev, self.generator,
            self.cfg, self._tdtype, self.device,
        )
        score = predict_score(self.plan, state.w0, state.w, state.V)
        if self.cfg.task == TASK_ORDERED:
            # Newton MAP cutpoints, then the latent draw
            state, _ = initialize_oprobit_core(
                score, state, self.y, self.cfg, _init_uniforms(self))
            return state
        # e = score − y for regression and ±1 classification
        return dataclasses.replace(state, e=score - self.y)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ) -> Tuple[Predictor, LearningHistory]:
        """Run the chain.  With ``checkpoint_path`` and
        ``checkpoint_every`` the chain state and the generator's state
        are written every N sweeps; ``resume=True`` continues from that
        checkpoint and reproduces the uninterrupted chain."""
        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume,
        )


class CategoricalGibbsTrainer:
    """Gibbs trainer on the entity-space fast path (one-hot and
    entity+attribute tables; see ops/categorical.py).  Runs on the
    plan's device; one ``torch.Generator`` seeded with ``random_seed``
    drives the chain.  A plan with entity+attribute tables resolves
    ``joint_tail_kernel`` as the joint engine does: its color scans run
    through kernel 4 where that engine's tail would."""

    def __init__(
        self,
        plan,  # CategoricalPlan
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        self.plan = plan
        self.cfg = _resolve_gram_fast_matmul(cfg, dtype, plan.device, rank)
        if plan.has_side:
            self.cfg = _resolve_joint_tail(self.cfg, plan, rank)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = _target(y, cfg, self.dtype, plan)
        # per-table tile-order copies of y (the regression target; the
        # probit tasks gather their latent τ every sweep instead)
        self.y_tiles = make_y_tiles(plan, self.y.to(self._tdtype))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(random_seed)

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "fastpath"

    def _sweep_call(self, state):
        variates = draw_sweep_variates(
            self.plan, self.cfg, self.rank, self.generator, self._tdtype,
            self.device,
        )
        return categorical_sweep(
            self.plan, state, self.y, self.y_tiles, variates, self.cfg
        )

    def _initialize(self):
        core = init_state(
            self.plan, self.rank, self.init_stdev, self.generator,
            self.cfg, self._tdtype, self.device,
        )
        u = (_init_uniforms(self) if self.cfg.task == TASK_ORDERED
             else None)
        return init_categorical_state(self.plan, core, self.y, self.cfg, u)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
    ) -> Tuple[Predictor, LearningHistory]:
        """Run the chain (checkpoints as in ``GibbsTrainer.run``)."""
        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback, checkpoint_path,
            checkpoint_every, resume, core_of=lambda s: s.core,
        )
