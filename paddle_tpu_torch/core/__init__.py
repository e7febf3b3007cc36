"""Core model engine: layer graph, topology, parameters (counterpart of
``paddle_tpu/core``)."""

from paddle_tpu_torch.core.arg import Arg, ArgInfo
from paddle_tpu_torch.core.layer import (Layer, LayerDef, LAYER_REGISTRY,
                                         register_layer)
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.core.parameters import Parameters
