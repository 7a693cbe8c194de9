"""myfm_tpu_torch — Bayesian Factorization Machines in PyTorch and CUDA.

The port of ``myfm_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
one slice at a time.  ``MyFMGibbsRegressor.fit`` → ``predict`` (the
regression task) runs on two engines, resolved by "auto" as the TPU
package resolves them:

* the categorical fast path, on designs whose every table is one-hot,
  with the per-entity Gram statistics computed by a hand-written CUDA
  kernel (ops/gram.py, csrc/fused_gram_cross.cu);
* the joint engine, on relational designs with N-hot block columns
  (the timeSVD++ features), with its sequential color tail run by a
  hand-written CUDA kernel (ops/joint_tail.py, csrc/joint_tail.cu), and
  row-space serving.

The colored engine, probit tasks, variational inference and multiple
devices are later slices and raise ``NotImplementedError``.  The
package imports neither JAX nor ``myfm_tpu``.
"""

from .base import ConfigBuilder, MyFMBase, std_cdf
from .containers import FM, FMHyperParameters, LearningHistory
from .gibbs import MyFMGibbsBase, MyFMGibbsRegressor, MyFMRegressor
from .predictor import Predictor
from .relational import RelationBlock

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
    "MyFMRegressor",
    "Predictor",
    "__version__",
]
