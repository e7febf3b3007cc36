"""Parameter initializers (counterpart of ``paddle_tpu/initializer.py``;
analog of the reference's parameter init strategies,
paddle/parameter/Parameter.cpp randomize: default normal with std =
1/sqrt(fan_in) unless initial_std is given; uniform; zero; constant),
selected by the ParamAttr fields.

Draws come from an explicit CPU ``torch.Generator``. They are not the JAX
package's draws from the same seed: parity tests carry the JAX
parameters over instead.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.attr import ParamAttr


def init_array(generator: torch.Generator, shape, attr: ParamAttr,
               fan_in: int, dtype=torch.float32,
               is_bias: bool = False) -> torch.Tensor:
    """Materialise one parameter on the CPU. Default: bias -> zeros;
    weight -> normal with std = initial_std or 1/sqrt(fan_in).
    initial_strategy None means unset (treated as normal)."""
    shape = tuple(shape)
    strat = attr.initial_strategy or "normal"

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (lo + (hi - lo) * u).to(dtype)

    if (attr.initial_max is not None or attr.initial_min is not None) \
            and attr.initial_mean is None and attr.initial_std is None:
        # explicit uniform window; mean/std take precedence when both are
        # given, and the window must be complete and ordered
        if attr.initial_max is None or attr.initial_min is None:
            raise ValueError("initial_max/initial_min must be set together")
        if not attr.initial_min < attr.initial_max:
            raise ValueError(
                f"initial_min ({attr.initial_min}) must be < initial_max "
                f"({attr.initial_max})")
        return uniform(attr.initial_min, attr.initial_max)
    if is_bias and attr.initial_std is None and attr.initial_mean is None \
            and strat == "normal":
        return torch.zeros(shape, dtype=dtype)
    if strat == "zero":
        return torch.zeros(shape, dtype=dtype)
    if strat == "constant":
        return torch.full(shape, attr.initial_value, dtype=dtype)
    mean = attr.initial_mean if attr.initial_mean is not None else 0.0
    std = attr.initial_std if attr.initial_std is not None \
        else 1.0 / math.sqrt(max(fan_in, 1))
    if strat == "uniform":
        # uniform in [mean-std, mean+std], the reference's init window
        return uniform(mean - std, mean + std)
    z = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (mean + std * z).to(dtype)
