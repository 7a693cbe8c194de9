"""Carry the TPU package's numbers across to this port.

These helpers take objects of ``myfm_tpu`` (a ``GibbsState`` with its
residual e and, for the ordered task, its cutpoints, unconstrained α and
MH accept counts, a ``CategoricalState`` with its latent τ, a ``VIState`` or
``CategoricalVIState``, ``FM`` samples, a ``Predictor``, a
``CategoricalPlan`` with or without entity+attribute tables, a
row-space ``DesignPlan``) by their attributes alone, read every array
with
``np.asarray``, and build the port's counterpart on a torch device — so
both packages can be run on the same numbers.  ``state_from_jax_checkpoint``
reads a chain checkpoint the TPU package wrote.  Nothing here imports
the TPU package or JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .checkpoint import state_fields, with_fields
from .containers import FM
from .design import (
    BlockPlan,
    ColorPlan,
    ColorStack,
    DenseColor,
    DenseStack,
    DesignPlan,
    TablePlan,
)
from .design_categorical import CategoricalPlan, CategoricalTable, SideInfo
from .ops.categorical import CategoricalState
from .ops.categorical_vi import CategoricalVIState
from .ops.gibbs import GibbsState
from .ops.variational import VIState
from .predictor import Predictor


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def state_from_numpy(state, device) -> GibbsState:
    """The port's GibbsState from any object with GibbsState's fields
    (the residual e included)."""
    return GibbsState(**{
        f.name: _tensor(getattr(state, f.name, None), device)
        for f in dataclasses.fields(GibbsState)
    })


def categorical_state_from_numpy(state, device) -> CategoricalState:
    """The port's CategoricalState (core, tau, sum_e, sum_e2)."""
    return CategoricalState(
        core=state_from_numpy(state.core, device),
        tau=_tensor(state.tau, device),
        sum_e=_tensor(state.sum_e, device),
        sum_e2=_tensor(state.sum_e2, device),
    )


def vi_state_from_numpy(state, device) -> VIState:
    """The port's VIState from any object with VIState's fields."""
    return VIState(**{
        f.name: _tensor(getattr(state, f.name), device)
        for f in dataclasses.fields(VIState)
    })


def categorical_vi_state_from_numpy(state, device) -> CategoricalVIState:
    """The port's CategoricalVIState (core, tau)."""
    return CategoricalVIState(
        core=vi_state_from_numpy(state.core, device),
        tau=_tensor(state.tau, device),
    )


def fm_from_numpy(fm) -> FM:
    """The port's FM container from one posterior sample (its cutpoint
    vectors, one per cutpoint group, included)."""
    return FM(
        float(fm.w0), np.asarray(fm.w), np.asarray(fm.V),
        [np.asarray(c) for c in getattr(fm, "cutpoints", []) or []],
    )


def predictor_from_numpy(predictor, device) -> Predictor:
    """A port Predictor holding the same kept samples."""
    out = Predictor(
        predictor.rank, predictor.n_features, predictor.task,
        predictor.dtype, device,
    )
    out.samples = [fm_from_numpy(s) for s in predictor.samples]
    return out


def _side_from_numpy(si, device):
    if si is None:
        return None
    return SideInfo(**{
        f.name: (si.n_cols if f.name == "n_cols"
                 else _tensor(getattr(si, f.name), device))
        for f in dataclasses.fields(SideInfo)
    })


def plan_from_numpy(plan, device) -> CategoricalPlan:
    """The port's CategoricalPlan from a TPU-package plan, its
    entity+attribute tables' ``SideInfo`` included."""
    tables = []
    for t in plan.tables:
        kw = {}
        for f in dataclasses.fields(CategoricalTable):
            v = getattr(t, f.name)
            if f.name == "fin_win":
                kw[f.name] = np.asarray(v, dtype=np.int32)
            elif isinstance(v, int):
                kw[f.name] = v
            else:
                dtype = np.int64 if f.name == "noise_feat" else None
                kw[f.name] = _tensor(v, device, dtype)
        tables.append(CategoricalTable(**kw))
    return CategoricalPlan(
        tables=tuple(tables),
        cross_ent=tuple(
            tuple(_tensor(m, device) for m in row) for row in plan.cross_ent
        ),
        group_index=_tensor(plan.group_index, device, np.int64),
        group_counts=_tensor(plan.group_counts, device),
        n_rows=plan.n_rows,
        n_features=plan.n_features,
        n_groups=plan.n_groups,
        side=tuple(_side_from_numpy(si, device)
                   for si in getattr(plan, "side", ())),
    )


# the plan class of each nested field of a row-space DesignPlan
_PLAN_FIELDS = {
    "main": TablePlan, "blocks": BlockPlan, "colors": ColorPlan,
    "color_stack": ColorStack, "dense_colors": DenseColor,
    "dense_stack": DenseStack,
}


def _plan_node(cls, obj, device):
    kw = {}
    for f in dataclasses.fields(cls):
        # the port's own fields (row_lo, n_total, the summation orders)
        # keep their defaults: the TPU package's plans have no such
        # attributes
        v = getattr(obj, f.name, f.default)
        sub = _PLAN_FIELDS.get(f.name)
        if v is None or isinstance(v, int):
            kw[f.name] = v
        elif sub is not None and isinstance(v, (tuple, list)):
            kw[f.name] = tuple(_plan_node(sub, x, device) for x in v)
        elif sub is not None:
            kw[f.name] = _plan_node(sub, v, device)
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


def design_plan_from_numpy(plan, device) -> DesignPlan:
    """The port's row-space DesignPlan from a TPU-package DesignPlan
    (every array read with ``np.asarray``, dtypes kept)."""
    return _plan_node(DesignPlan, plan, device)


def state_from_jax_checkpoint(path: str, like):
    """(state, iteration) from a checkpoint of the TPU package's
    ``save_checkpoint``: an npz of the state pytree's leaves
    (``leaf_0``, ...) and the sweeps done.  The leaves are the state's
    fields in order, nested states depth first, None fields left out,
    so ``like`` (the port's state of the same chain, e.g. a trainer's
    ``_initialize()``) gives the structure, which fields are None, and
    each tensor's device and dtype.  The chain's generator state is not
    in such a file: the TPU package derives its keys from the seed."""
    with np.load(path) as data:
        ref = dict(state_fields(like))
        present = [name for name, v in ref.items() if v is not None]
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_leaves != len(present):
            raise ValueError(
                f"{path} holds {n_leaves} leaves, the state has "
                f"{len(present)} fields that are not None: {present}")
        values = dict.fromkeys(ref)
        for i, name in enumerate(present):
            r = ref[name]
            values[name] = torch.tensor(data[f"leaf_{i}"], dtype=r.dtype,
                                        device=r.device)
        iteration = int(data["iteration"])
    return with_fields(like, values), iteration
