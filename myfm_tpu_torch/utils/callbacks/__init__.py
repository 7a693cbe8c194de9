"""libFM-style evaluation callbacks (counterpart of
``myfm_tpu/utils/callbacks``)."""

from .libfm import (
    ClassificationCallback,
    LibFMLikeCallbackBase,
    OrderedProbitCallback,
    RegressionCallback,
)

__all__ = [
    "LibFMLikeCallbackBase",
    "RegressionCallback",
    "ClassificationCallback",
    "OrderedProbitCallback",
]
