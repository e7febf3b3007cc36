"""Parameter / layer attributes (counterpart of ``paddle_tpu/attr.py``;
analog of python/paddle/trainer_config_helpers/attrs.py).

The fields are the JAX package's, so a config written against one reads
the same against the other; this slice of the port serves inference, so
only ``name`` is read so far (the initializer and optimizer fields come
with training).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ParamAttr:
    """Per-parameter attributes (ParameterConfig.proto analog)."""

    name: Optional[str] = None
    initial_mean: Optional[float] = None
    initial_std: Optional[float] = None
    initial_strategy: Optional[str] = None
    initial_value: float = 0.0
    initial_max: Optional[float] = None
    initial_min: Optional[float] = None
    is_static: bool = False
    learning_rate: float = 1.0
    momentum: Optional[float] = None
    l1_rate: Optional[float] = None
    l2_rate: Optional[float] = None
    sparse_update: bool = False
    host_resident: bool = False
    gradient_clipping_threshold: Optional[float] = None
    is_shared: bool = False


ParameterAttribute = ParamAttr


@dataclasses.dataclass
class ExtraAttr:
    """Extra layer attributes (ExtraLayerAttribute analog)."""

    drop_rate: Optional[float] = None
    device: Optional[int] = None
    error_clipping_threshold: Optional[float] = None


ExtraLayerAttribute = ExtraAttr


def to_param_attr(x) -> ParamAttr:
    if x is None:
        return ParamAttr()
    if isinstance(x, ParamAttr):
        return x
    if isinstance(x, dict):
        return ParamAttr(**x)
    raise TypeError(f"cannot convert {type(x)} to ParamAttr")
