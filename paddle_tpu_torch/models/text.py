"""RNN text models (counterpart of ``paddle_tpu/models/text.py``;
benchmark/paddle/rnn/{rnn.py,imdb.py} parity). This slice of the port has
the stacked LSTM classifier.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import data_type, layer, networks, pooling


def lstm_text_classification(dict_dim=30000, emb_dim=128, hidden=512,
                             num_layers=2, num_classes=2, name="lstm_cls"):
    """2xLSTM + fc text classifier (the benchmark RNN config: IMDB,
    seq len 100, dict 30k, h=512)."""
    words = layer.data(name="words",
                       type=data_type.integer_value_sequence(dict_dim))
    lab = layer.data(name="label", type=data_type.integer_value(num_classes))
    emb = layer.embedding(input=words, size=emb_dim)
    cur = emb
    for i in range(num_layers):
        cur = networks.simple_lstm(input=cur, size=hidden,
                                   name=f"{name}_l{i}")
    pooled = layer.pooling(input=cur, pooling_type=pooling.Max())
    out = layer.fc(input=pooled, size=num_classes, act=act.Linear(),
                   name="output")
    cost = layer.classification_cost(input=out, label=lab, name="cost")
    return words, lab, out, cost
