"""Carry the TPU package's numbers across to this port.

These helpers take objects of ``myfm_tpu`` (a ``GibbsState`` with its
residual e, a ``CategoricalState``, ``FM`` samples, a ``Predictor``, a
``CategoricalPlan``, a row-space ``DesignPlan``) by their attributes
alone, read every array with
``np.asarray``, and build the port's counterpart on a torch device — so
both packages can be run on the same numbers.  Nothing here imports the
TPU package or JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
from .design_categorical import CategoricalPlan, CategoricalTable
from .ops.categorical import CategoricalState
from .ops.gibbs import GibbsState
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


def fm_from_numpy(fm) -> FM:
    """The port's FM container from one posterior sample."""
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


def plan_from_numpy(plan, device) -> CategoricalPlan:
    """The port's CategoricalPlan from a one-hot TPU-package plan."""
    if any(si is not None for si in getattr(plan, "side", ())):
        raise NotImplementedError(
            "entity+attribute (side-feature) tables: later slice"
        )
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
        v = getattr(obj, f.name)
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
