"""One run of a benchmark cell.

Set-up makes the ratings from the seed, has the configuration's
reference module build the design of both splits (``design``), runs a cold
fit of a few sweeps (it builds the plan, warms every shape and fills the
plan cache) and starts the measured fit, a refit whose chain runs until
the window ends.  The window opens once the measured fit's first sweep
is done and closes at a synchronize after the sweep at which its time is
up; the fit then stops through its callback, which keeps the trainer's
pipelined harvest.  A traced run (``trace``) profiles a slice of sweeps
inside the window, with the program's spans recorded from before the
cold fit (``myfm_tpu_torch.tracing.recording``).

Correctness: a wrapper around the trainer's sweep call keeps, for the
measured fit's first sweep and one sweep of the window drawn from the
seed (and the sweep before it), the state the sweep started from, the
standard variates it applied and the state it returned.  After the
window the plain reference repeats those sweeps from the same state and
variates in float64 and the comparison of ``check`` judges what the
program returned as its user sees it: the kept samples and the
hyperparameter trace, or in the libFM mix the state its callback scored
and the callback's held-out scores and RMSE.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import math
import sys
import time

import numpy as np
import torch

from . import data as data_mod
from . import registry, roofline
from . import spans as spans_mod
from . import trace as trace_mod

# an n_iter no window reaches: the window's callback stops the chain
UNREACHED_SWEEPS = 10 ** 7
# the cold fit's sweeps: past the harvest's lag of 3, so every shape and
# buffer of the measured fit's steady state is warm
COLD_FIT_SWEEPS = 4
# the checked window sweep is drawn from sweeps 2 .. CHECK_WITHIN, which
# every cell reaches in a few seconds; from 2 on, the sweep before it is
# a window sweep too, so every seed keeps the same two sweeps' records
# on the card (with sweep 1 checked, sweep 0's went to the host and the
# peak read one sweep's state and variates less)
CHECK_WITHIN = 16
# the traced slice: SLICE_SWEEPS sweeps after the window's SLICE_AFTER-th
SLICE_AFTER, SLICE_SWEEPS = 4, 12
FORBIDDEN = ("jax", "jaxlib", "flax", "myfm_tpu")
STATE = ("w0", "w", "V", "alpha", "mu_w", "lambda_w", "mu_V", "lambda_V")
VARIATES = ("gamma_alpha", "normal_w0", "gamma_lambda_w", "normal_mu_w",
            "gamma_lambda_V", "normal_mu_V", "noise_w", "noise_V")
HYPERS = ("alpha", "mu_w", "lambda_w", "mu_V", "lambda_V")


def seeds(seed: int, check_within: int):
    """(data seed, fit seed, checked window sweep in 2 .. check_within)
    from ``--seed``."""
    a, b, c = np.random.SeedSequence(seed % (1 << 64)).generate_state(3)
    return int(a), int(b) % (1 << 31), 2 + int(c) % (check_within - 1)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Device:
    """The few device calls the run makes, no-ops on the CPU (tests)."""

    def __init__(self, name: str):
        self.name = name
        self.cuda = torch.device(name).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        """A point on the compute stream (CUDA event), or the host clock."""
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def gap_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0


def _program_design(part):
    """The program's (X, X_rel, grouping) from a reference module's
    design of one split, whose blocks are (mapper, matrix) pairs."""
    from myfm_tpu_torch import RelationBlock

    X, blocks, grouping = part
    return X, [RelationBlock(m, d) for m, d in blocks], grouping


def _fields(obj, names, host: bool):
    out = {k: getattr(obj, k) for k in names}
    return {k: v.detach().cpu() if host else v for k, v in out.items()}


class SweepCapture:
    """Stands in for the trainer's ``categorical_sweep``: keeps, for the
    sweeps in ``keep`` (index -> copy to the host at once), the state a
    sweep starts from, its variates and the state it returns; in traced
    runs it wraps every sweep in a ``bench.sweep`` range."""

    def __init__(self, inner, keep: dict, span: bool):
        self.inner, self.keep, self.span = inner, keep, span
        self.calls = 0
        self.records = {}

    def __call__(self, plan, state, y, y_tiles, variates, cfg, *a, **kw):
        i = self.calls
        self.calls += 1
        with (torch.profiler.record_function("bench.sweep") if self.span
              else contextlib.nullcontext()):
            out = self.inner(plan, state, y, y_tiles, variates, cfg, *a,
                             **kw)
        if i in self.keep:
            host = self.keep[i]
            self.records[i] = dict(
                state_in=_fields(state.core, STATE, host),
                variates=_fields(variates, VARIATES, host),
                state_out=_fields(out.core, STATE, host),
            )
        return out


class Kernel1Bounds:
    """Stands in for kernel 1 in the sweep module of a traced run: while
    ``active``, each call's bound (ms, from the operands' shapes) is
    kept."""

    def __init__(self, inner):
        self.inner = inner
        self.active = False
        self.bounds_ms = []

    def __call__(self, *args, **kwargs):
        if not self.active:
            return self.inner(*args, **kwargs)
        self.bounds_ms.append(roofline.bound(
            *roofline.kernel1_call(args, kwargs))[0])
        return self.inner(*args, **kwargs)


class Window:
    """The measured fit's callback: opens the window after sweep 0,
    closes it at the sweep at which ``seconds`` have passed (and not
    before sweep ``min_sweeps``, the checked one), and around
    that times the inner (user) callback, marks every sweep on the
    stream, keeps the inner callback's score of sweep ``score_at`` and
    runs the traced slice of sweeps ``slice_at``."""

    def __init__(self, dev: Device, seconds: float, inner, counters,
                 score_at=None, slice_at=None, kernel1=None, min_sweeps=0):
        self.dev, self.seconds, self.inner = dev, seconds, inner
        self.min_sweeps = min_sweeps
        self.counters = counters
        self.allow_async_trace = inner is None or bool(
            getattr(inner, "allow_async_trace", False))
        self.score_at, self.slice_at, self.kernel1 = score_at, slice_at, \
            kernel1
        self.marks, self.callback_s = [], []
        self.score = None
        self.prof = self.slice_range = None
        self.slice_sweeps = 0
        # host clock before the slice's opening synchronize and after its
        # closing one: the sweeps inside ran under the profiler
        self.t_slice = None
        self.t_open = self.t_close = None

    def _inner(self, i, fm, hyper, history):
        before = (self.inner.predictions.copy() if i == self.score_at
                  else None)
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.callback")
              if self.slice_range is not None
              else contextlib.nullcontext()):
            self.inner(i, fm, hyper, history)
        if i > 0:
            self.callback_s.append(time.perf_counter() - t0)
        if before is not None:
            self.score = self.inner.predictions - before

    def _slice(self, i):
        if self.slice_at is None:
            return
        first, n = self.slice_at
        if i == first:
            self.t_slice = [time.perf_counter(), None]
            self.dev.sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.slice_range = torch.profiler.record_function(
                trace_mod.SLICE)
            self.slice_range.__enter__()
            self.kernel1.active = True
        elif i == first + n:
            self.end_slice(i)

    def end_slice(self, i):
        """Close the traced slice after sweep ``i`` (if it is open)."""
        if self.slice_range is None:
            return
        self.dev.sync()
        self.kernel1.active = False
        self.slice_range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.slice_range = None
        self.slice_sweeps = i - self.slice_at[0]
        self.t_slice[1] = time.perf_counter()

    def profiled(self) -> set:
        """The sweep gaps (mark i to mark i + 1) that the traced slice
        touches: its sweeps, and the profiler's start and stop."""
        if self.t_slice is None:
            return set()
        first = self.slice_at[0]
        return set(range(first, first + self.slice_sweeps + 1))

    def slice_s(self) -> float:
        return 0.0 if self.t_slice is None else (
            self.t_slice[1] - self.t_slice[0])

    def __call__(self, i, fm, hyper, history):
        if self.inner is not None:
            self._inner(i, fm, hyper, history)
        self.marks.append(self.dev.mark())
        if i == 0:
            self.dev.sync()
            self.t_open = time.perf_counter()
            self.at_open = self.counters()
            return False, None
        self._slice(i)
        if (time.perf_counter() - self.t_open < self.seconds
                or i < self.min_sweeps):
            return False, None
        self.end_slice(i)
        self.dev.sync()
        self.t_close = time.perf_counter()
        self.at_close = self.counters()
        self.sweeps = i
        self.peak = self.dev.peak_bytes()
        return True, None


class FirstSweep:
    """The cold fit's callback: the host clock at its first sweep done."""

    def __init__(self, dev: Device, inner):
        self.dev, self.inner, self.t_first = dev, inner, None
        self.allow_async_trace = inner is None or bool(
            getattr(inner, "allow_async_trace", False))

    def __call__(self, i, fm, hyper, history):
        if self.inner is not None:
            self.inner(i, fm, hyper, history)
        if i == 0:
            self.dev.sync()
            self.t_first = time.perf_counter()
        return False, None


def warm_profiler():
    """One short trace before the traced one: the first trace of a
    process can lose its kernel events (``tools/vi_gram.device_ms``
    throws one away for the same reason)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def read_counter(path: str):
    """A copy of the program counter at ``path``, "<module>:<attribute
    path>" (``myfm_tpu_torch.ops.entity_draws:entity_draws.launches``)."""
    module, _, attributes = path.partition(":")
    value = importlib.import_module(module)
    for name in attributes.split("."):
        value = getattr(value, name)
    return copy.deepcopy(value)


def _counters(device_type: str, declared: dict):
    """The program's counters the window reads at its open and close:
    the loop's host syncs, kernel 1's launches by mode, the plan cache's
    bytes, and under ``declared`` those the cell's metric readers
    declare ({key: path})."""
    from myfm_tpu_torch.design_cache import plan_cache_bytes
    from myfm_tpu_torch.ops import gram
    from myfm_tpu_torch.trainer import run_mcmc_loop

    return dict(
        host_syncs=run_mcmc_loop.host_syncs,
        kernel1=dict(gram.fused_tile_gram_cross.mode_launches["gibbs"]),
        plan_cache_bytes=plan_cache_bytes(device_type),
        declared={k: read_counter(p) for k, p in declared.items()},
    )


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield value
    finally:
        setattr(module, name, old)


def _forced_gram(mode):
    """The estimator's config builder with the Gram mode fixed to
    ``mode`` (the control's path: the program's own lower-precision
    mode), or None to leave "auto"."""
    if mode is None:
        return contextlib.nullcontext()
    import dataclasses

    from myfm_tpu_torch import gibbs

    inner = gibbs._gibbs_config
    return _patched(gibbs, "_gibbs_config", lambda *a, **k: dataclasses.
                    replace(inner(*a, **k), gram_fast_matmul=mode))


def _callback(traffic, test_design, y_test):
    """The traffic mix's user callback (a class of the program's
    ``utils.callbacks`` with the mix's arguments), or None."""
    spec = traffic.get("callback")
    if spec is None:
        return None
    from myfm_tpu_torch.utils import callbacks

    X_test, blocks_test, _ = test_design
    return getattr(callbacks, spec["class"])(
        UNREACHED_SWEEPS, X_test, y_test, X_rel_test=blocks_test,
        trace_path=None, **spec.get("kwargs", {}))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", spec=None,
             bench_dir=registry.BENCH_DIR, overrides=None, force_gram=None,
             control: bool = False) -> dict:
    """One run; returns the result object (and ``observed``, the raw
    readings the per-layer readers take their metrics from: among them
    ``design``, the reference module's sizes of the design; ``counters``,
    {key: (at the window's open, at its close)} of the counters the
    readers declare; in a traced run ``trace``, the slice's device
    readings with the device ms of every operation by kernel name
    (``kernel_ms``) and by the innermost program span that launched it
    (``span_device_ms``), and ``spans``: the recorded spans
    (``records``), the measured fit (``fit``), its window sweeps outside
    the slice (``sweeps``) and their host ms per sweep by span name,
    [total, own] (``host_ms``)).
    ``overrides`` replaces keys of the configuration, the sizes of its
    ``dataset`` one by one (the CPU tests at a small size),
    ``force_gram`` fixes the program's Gram mode and ``control`` puts
    the reference one precision below the configuration's in the
    program's place in the comparison (the control: its checks are
    judged, and ``observed["program_checks"]`` holds the program's).
    """
    from myfm_tpu_torch import clear_plan_cache, tracing, trainer
    from myfm_tpu_torch.design_cache import get_or_build
    from myfm_tpu_torch.ops import categorical

    spec = spec or registry.load_spec()
    cell = registry.cell(workload, spec, bench_dir)
    config, traffic = dict(cell["config"]), cell["traffic"]
    for key, value in (overrides or {}).items():
        config[key] = (dict(config[key], **value) if key == "dataset"
                       else value)
    ref = registry.reference(config, bench_dir)
    dev = Device(device)
    data_seed, fit_seed, checked = seeds(seed, CHECK_WITHIN)

    stamps = [("imports_and_card", time.perf_counter())]
    train, test = data_mod.make_ratings(config["dataset"], data_seed, device)
    stamps.append(("data", time.perf_counter()))
    design = ref.design(config, train, test)
    X, blocks, grouping = _program_design(design["program"]["train"])
    X_test, blocks_test, _ = _program_design(design["program"]["test"])
    stamps.append(("design", time.perf_counter()))
    keep_all = traffic["n_kept"] == "all"
    Estimator = getattr(importlib.import_module("myfm_tpu_torch"),
                        config["estimator"])

    def fit(n_iter, callback):
        fm = Estimator(rank=config["rank"], random_seed=fit_seed,
                       sweep_strategy=config["sweep_strategy"],
                       device=device, **config["prior"])
        return fm.fit(X, train.y, X_rel=blocks, n_iter=n_iter,
                      n_kept_samples=n_iter if keep_all
                      else traffic["n_kept"],
                      grouping=grouping, callback=callback)

    if trace and dev.cuda:
        warm_profiler()
    # a traced run records the program's spans; an untraced one records
    # none, so its end-to-end numbers carry no span's cost
    with _forced_gram(force_gram), (
            tracing.recording() if trace
            else contextlib.nullcontext()) as recorded:
        clear_plan_cache()
        cold = FirstSweep(dev, _callback(traffic, (X_test, blocks_test, None),
                                         test.y))
        t_cold = time.perf_counter()
        fit(COLD_FIT_SWEEPS, cold)
        stamps.append(("cold_fit", time.perf_counter()))
        observed = dict(cold_first_sweep_s=cold.t_first - t_cold)
        del cold

        inner = _callback(traffic, (X_test, blocks_test, None), test.y)
        capture = SweepCapture(trainer.categorical_sweep,
                               {checked - 1: False, checked: False,
                                0: True}, span=trace)
        kernel1 = Kernel1Bounds(categorical.fused_tile_gram_cross)
        slice_at = (SLICE_AFTER, SLICE_SWEEPS) if trace else None
        window = Window(dev, seconds, inner,
                        lambda: _counters(torch.device(device).type,
                                          cell["counters"]),
                        score_at=checked if inner is not None else None,
                        slice_at=slice_at, kernel1=kernel1,
                        min_sweeps=checked)
        hits = get_or_build.hits
        t_fit = time.perf_counter()
        with _patched(trainer, "categorical_sweep", capture), \
                _patched(categorical, "fused_tile_gram_cross", kernel1):
            fm = fit(UNREACHED_SWEEPS, window)
    if window.t_close is None:
        raise RuntimeError("the chain ended before the window closed")
    if get_or_build.hits - hits != 1:
        raise RuntimeError("the measured fit did not find its plan cached")
    want = force_gram or config["precision"]["gram"]
    launched = {m: n - window.at_open["kernel1"][m]
                for m, n in window.at_close["kernel1"].items()}
    ran = sorted(m for m, n in launched.items() if n)
    history = fm.history_
    if history.engine != config["engine"] or (dev.cuda and (
            history.gram_fast_matmul != want or ran != [want])):
        raise RuntimeError(
            f"the fit ran engine {history.engine!r}, Gram mode "
            f"{history.gram_fast_matmul!r}, kernel 1 launches by mode "
            f"{launched}; the configuration states {config['engine']!r}, "
            f"{want!r}")

    n = window.sweeps
    window_s = window.t_close - window.t_open
    # a traced run's rate and sweep gaps leave out the traced slice: the
    # profiler slows its sweeps and its start and stop
    skip = window.profiled()
    stamps.append(("measured_fit_start", window.t_open))
    observed.update(
        setup_parts={name: t - stamps[i - 1][1] if i else t - t_start
                     for i, (name, t) in enumerate(stamps)},
        warm_first_sweep_s=window.t_open - t_fit,
        plan_cache_bytes=window.at_open["plan_cache_bytes"],
        window_sweeps=n, window_s=window_s,
        sweeps_per_s=(n - window.slice_sweeps) / (window_s
                                                  - window.slice_s()),
        host_syncs=window.at_close["host_syncs"]
        - window.at_open["host_syncs"],
        kernel1_launches=sum(launched.values()),
        sweep_ms=[dev.gap_ms(window.marks[i], window.marks[i + 1])
                  for i in range(n) if i not in skip],
        callback_s=window.callback_s if inner is not None else None,
        sweep_flops=ref.sweep_flops(config, design,
                                    len(test) if inner is not None else 0),
        design=design["shape"],
        counters={k: (window.at_open["declared"][k],
                      window.at_close["declared"][k])
                  for k in cell["counters"]},
    )
    if trace:
        if window.slice_sweeps < 1:
            raise RuntimeError("the window closed before its traced slice")
        events = window.prof.events()
        summary = trace_mod.summarize(events)
        summary.update(
            sweeps=window.slice_sweeps, kernel1_bound_ms=kernel1.bounds_ms,
            span_device_ms=spans_mod.device_split(events)["span_device_ms"])
        observed["trace"] = summary
        fit, sweeps = spans_mod.measured_sweeps(
            recorded.spans, n, SLICE_AFTER, window.slice_sweeps)
        observed["spans"] = dict(
            records=recorded.spans, fit=fit, sweeps=sweeps,
            host_ms=spans_mod.host_ms_by_name(recorded.spans, fit, sweeps))
        del events
    peak = window.peak

    answers = _answers(fm, capture, checked, keep_all)
    callback_rmse = (inner.result_trace[checked]["rmse_this"]
                     if inner is not None else None)
    del fm, capture.records
    clear_plan_cache()
    if dev.cuda:
        torch.cuda.empty_cache()
    checks, program_checks = check(ref, config, design["reference"], test.y,
                                   answers, window.score, callback_rmse,
                                   device, cell["limits"], control)

    result = dict(
        correct=all(c["value"] <= c["limit"] for c in checks.values()),
        attempted=n, failed=0,
        metrics=_metrics(cell, observed, t_start, window, trace),
        device=_device_info(dev, peak, observed.get("trace")),
    )
    if trace:
        result["breakdown"] = dict(
            device_ops=observed["trace"]["device_ops"],
            idle_gaps=observed["trace"]["idle_gaps"])
    result["checks"] = checks
    observed["program_checks"] = program_checks or checks
    return result, observed


def _answers(fm, capture, checked, keep_all) -> dict:
    """What the checked sweeps returned, on the host: the state each
    started from (the program's own), its variates, and the values its
    user sees (the kept sample, or the state the callback scored, with
    the hyperparameter trace), and the largest difference between those
    and the state the sweep returned on the device, with the sweep
    before the checked one handing its state on unchanged."""
    recs = capture.records
    out, carry = {}, 0.0

    def diff(a, b):
        d = (a.detach().cpu().double() - torch.as_tensor(
            np.asarray(b, dtype=np.float64))).abs()
        return float(d.nan_to_num(math.inf).max()) if d.numel() else 0.0

    for j in (0, checked):
        rec = recs[j]
        seen = {}
        if keep_all:
            sample = fm.predictor_.samples[j]
            seen.update(w0=sample.w0, w=sample.w, V=sample.V)
        else:
            seen.update({k: rec["state_out"][k].cpu().numpy()
                         for k in ("w0", "w", "V")})
        hyper = fm.history_.hypers[j]
        seen.update({k: getattr(hyper, k) for k in HYPERS})
        for k, v in seen.items():
            carry = max(carry, diff(rec["state_out"][k], v))
        out[j] = dict(
            state_in={k: v.detach().cpu() for k, v in rec["state_in"].items()},
            variates={k: v.detach().cpu() for k, v in rec["variates"].items()},
            program={k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                     for k, v in seen.items()})
    before = recs[checked - 1]["state_out"]
    for k in STATE:
        carry = max(carry, diff(recs[checked]["state_in"][k],
                                before[k].detach().cpu().numpy()))
    out["carry_diff"] = carry
    return out


def _to(device, obj):
    """``obj`` with every tensor in it (through dicts, lists and tuples)
    on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(device, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(device, v) for v in obj)
    return obj


def check(ref, config, designs, y_test, answers, cb_score, cb_rmse, device,
          limits, control=False) -> tuple:
    """The compared numbers, each with its limit: the widest gap of the
    checked sweeps' draws from the reference's (``ref``, the
    configuration's reference module, on its own ``designs`` of the two
    splits), in conditional standard deviations, over the weights (w,
    V) and over the hyperparameters (α, w0, λ, μ); the carried state's
    largest difference (exact); and in a mix with a held-out callback
    the widest gap of its scores and of its RMSE against ``y_test`` from
    the reference forward's.  With ``control`` the plain reference
    computed one precision below the configuration's is put in the
    program's place: the weights drawn from Gram operands rounded to
    ``precision.control_gram``, the hyperparameters from statistics and
    the held-out scores from a forward in ``precision.control_float``;
    the checks returned are then the control's, and the second dict the
    program's own."""
    precision = config["precision"]
    lowered = dict(
        weight_gap_sd=dict(gram_dtype=getattr(torch, precision[
            "control_gram"])),
        hyper_gap_sd=dict(stat_dtype=getattr(torch, precision[
            "control_float"])))
    design = _to(device, designs["train"])
    groups = dict(weight_gap_sd=ref.WEIGHTS, hyper_gap_sd=ref.HYPERS)
    judged = ("program", "control") if control else ("program",)
    worst = {side: {k: (0.0, "") for k in groups} for side in judged}
    for j in sorted(k for k in answers if isinstance(k, int)):
        a = answers[j]
        on = {k: {n: v.to(device) for n, v in a[k].items()}
              for k in ("state_in", "variates")}
        draws, sds = ref.sweep(design, config["prior"], on["state_in"],
                               on["variates"])
        for key, names in groups.items():
            got = dict(program=a["program"])
            if control:
                got["control"], _ = ref.sweep(
                    design, config["prior"], on["state_in"], on["variates"],
                    **lowered[key])
            for side, values in got.items():
                g, name = ref.widest_gap_sd(values, draws, sds, names)
                if not g <= worst[side][key][0]:
                    worst[side][key] = (g, f"{name} of sweep {j}")
            del got
        del draws, sds
    checks = {side: {key: dict(value=g, limit=limits[key], at=at)
                     for key, (g, at) in worst[side].items()}
              for side in judged}
    for side in judged:
        checks[side]["carry_diff"] = dict(value=answers["carry_diff"],
                                          limit=0.0)
    if cb_score is not None:
        del design
        last = max(k for k in answers if isinstance(k, int))
        out = answers[last]["program"]
        args = (_to(device, designs["test"]), out["w0"].to(device),
                out["w"].to(device), out["V"].to(device))
        score = ref.forward(*args)
        y_test = torch.as_tensor(y_test, device=device)
        rmse = ref.rmse(score, y_test)
        scored = dict(program=(torch.as_tensor(cb_score, device=device),
                               cb_rmse))
        if control:
            low = ref.forward(*args, dtype=getattr(
                torch, precision["control_float"]))
            scored["control"] = (low, ref.rmse(low, y_test))
        for side, (got, got_rmse) in scored.items():
            checks[side]["score_gap"] = dict(
                value=float((got - score).abs().max()),
                limit=limits["score_gap"])
            checks[side]["rmse_gap"] = dict(value=abs(got_rmse - rmse),
                                            limit=limits["rmse_gap"])
    for c in (c for side in judged for c in checks[side].values()):
        if math.isnan(c["value"]):
            c["value"] = math.inf
    if control:
        return checks["control"], checks["program"]
    return checks["program"], {}


def _metrics(cell, observed, t_start, window, trace) -> dict:
    if trace:
        out = {}
        for m in cell["per_layer"]:
            value = cell["readers"][m["name"]].read(observed)
            if value is not None:
                out[m["name"]] = dict(value=value, unit=m["unit"])
        return out
    values = dict(
        sweeps_per_s=observed["sweeps_per_s"],
        peak_device_gib=window.peak / 2 ** 30,
        setup_s=window.t_open - t_start,
    )
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell["end_to_end"]}


def _device_info(dev, peak, summary) -> dict:
    info = dict(platform="gpu" if dev.cuda else "cpu",
                kind=torch.cuda.get_device_name(0) if dev.cuda else "cpu",
                count=1, memory_peak_bytes=peak)
    if summary is not None:
        info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return info
