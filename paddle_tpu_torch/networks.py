"""Network presets (counterpart of ``paddle_tpu/networks.py``; analog of
python/paddle/trainer_config_helpers/networks.py). This slice of the port
has ``simple_lstm``.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layer


def simple_lstm(input, size, name=None, reverse=False, mat_param_attr=None,
                bias_param_attr=None, inner_param_attr=None, act=None,
                gate_act=None, state_act=None, mixed_layer_attr=None,
                lstm_cell_attr=None):
    """fc(4*size, identity act) -> lstmemory (networks.py:615-633 parity:
    act/gate_act/state_act configure the lstmemory cell, not the
    projection)."""
    mix = layer.fc(input=input, size=size * 4, act=act_linear(),
                   param_attr=mat_param_attr, bias_attr=False,
                   name=name and f"{name}_transform")
    return layer.lstmemory(input=mix, name=name, reverse=reverse,
                           act=act, gate_act=gate_act, state_act=state_act,
                           param_attr=inner_param_attr,
                           bias_attr=bias_param_attr,
                           layer_attr=lstm_cell_attr)


def act_linear():
    return act.Linear()
