"""Pooling type markers (counterpart of ``paddle_tpu/pooling.py``; analog
of python/paddle/trainer_config_helpers/poolings.py). The port pools with
``Max``, ``Avg``, ``Sum`` and ``SquareRootN``."""


class BasePoolingType:
    name = "base"


class Max(BasePoolingType):
    name = "max"


class Avg(BasePoolingType):
    name = "average"


class Sum(BasePoolingType):
    name = "sum"


class SquareRootN(BasePoolingType):
    """sum / sqrt(len) sequence pooling (reference SquareRootNPooling)."""
    name = "squarerootn"


def resolve(p):
    if p is None:
        return Max()
    if isinstance(p, BasePoolingType):
        return p
    if isinstance(p, type) and issubclass(p, BasePoolingType):
        return p()
    raise TypeError(f"cannot resolve pooling type from {p!r}")
