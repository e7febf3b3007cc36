"""Pooling type markers (counterpart of ``paddle_tpu/pooling.py``; analog
of python/paddle/trainer_config_helpers/poolings.py). This slice of the
port pools with ``Max``."""


class BasePoolingType:
    name = "base"


class Max(BasePoolingType):
    name = "max"


def resolve(p):
    if p is None:
        return Max()
    if isinstance(p, BasePoolingType):
        return p
    if isinstance(p, type) and issubclass(p, BasePoolingType):
        return p()
    raise TypeError(f"cannot resolve pooling type from {p!r}")
