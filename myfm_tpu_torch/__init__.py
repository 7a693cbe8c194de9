"""myfm_tpu_torch — Bayesian Factorization Machines in PyTorch and CUDA.

The port of ``myfm_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
one slice at a time.  The Gibbs estimators ``MyFMGibbsRegressor``,
``MyFMGibbsClassifier`` (probit) and ``MyFMOrderedProbit`` run ``fit``
→ ``predict`` on three engines, resolved by "auto" as the TPU package
resolves them, whatever the task:

* the categorical fast path, on designs whose every table is one-hot,
  with the per-entity Gram statistics computed by a hand-written CUDA
  kernel (ops/gram.py, csrc/fused_gram_cross.cu);
* the joint engine, on relational designs with N-hot block columns
  (the timeSVD++ features), with its sequential color tail run by a
  hand-written CUDA kernel (ops/joint_tail.py, csrc/joint_tail.cu), and
  row-space serving (without the linear terms the joint engine draws
  the factor rows alone, in plain PyTorch);
* the colored engine (ops/gibbs.py ``sweep_w`` / ``sweep_V``, plain
  PyTorch: the TPU package runs no Pallas kernel there) wherever "auto"
  takes neither of the others, or with ``sweep_strategy`` "colored" or
  "serial".

The categorical fast path also takes designs whose blocks carry
per-entity side features (entity+attribute tables), their side-feature
color scans run by the same tail kernel.

``VariationalFMRegressor`` and ``VariationalFMClassifier`` (probit) run
deterministic CAVI ``fit`` → ``predict`` / ``predict_proba`` on two
engines, resolved as the TPU package resolves them:

* the entity-space fast path, on all-one-hot and entity+attribute
  designs, with the Gram statistics computed by the same CUDA source in
  its VI layout and by its separate-meta variant (ops/gram.py
  ``fused_tile_gram``);
* the row-space colored sweep (ops/variational.py ``vi_sweep``, plain
  PyTorch) on every other design, or with ``sweep_strategy`` "colored"
  or "serial".

Plans are cached by design content (``clear_plan_cache`` frees them),
the Gibbs trainers checkpoint and resume their chains
(``trainer.run(..., checkpoint_path=, checkpoint_every=, resume=)``),
and the design planner's sequential passes run in a native library
built at first use.  Multiple devices are a later slice and raise
``NotImplementedError``.  The package imports neither JAX nor
``myfm_tpu``.
"""

from .base import ConfigBuilder, MyFMBase, std_cdf
from .containers import (
    FM,
    FMHyperParameters,
    LearningHistory,
    VariationalFM,
    VariationalFMHyperParameters,
    VariationalLearningHistory,
)
from .gibbs import (
    MyFMClassifier,
    MyFMGibbsBase,
    MyFMGibbsClassifier,
    MyFMGibbsRegressor,
    MyFMOrderedProbit,
    MyFMRegressor,
)
from .design_cache import clear_plan_cache
from .ops.special import (
    mean_var_truncated_normal_left,
    mean_var_truncated_normal_right,
)
from .predictor import Predictor, VariationalPredictor
from .relational import RelationBlock
from .variational import (
    MyFMVariationalBase,
    VariationalFMClassifier,
    VariationalFMRegressor,
)

__version__ = "0.1.0"

__all__ = [
    "RelationBlock",
    "ConfigBuilder",
    "MyFMBase",
    "std_cdf",
    "FM",
    "FMHyperParameters",
    "LearningHistory",
    "MyFMGibbsBase",
    "MyFMGibbsRegressor",
    "MyFMGibbsClassifier",
    "MyFMOrderedProbit",
    "MyFMRegressor",
    "MyFMClassifier",
    "Predictor",
    "VariationalFM",
    "VariationalFMHyperParameters",
    "VariationalLearningHistory",
    "MyFMVariationalBase",
    "VariationalFMRegressor",
    "VariationalFMClassifier",
    "VariationalPredictor",
    "mean_var_truncated_normal_left",
    "mean_var_truncated_normal_right",
    "clear_plan_cache",
    "__version__",
]
