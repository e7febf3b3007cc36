"""The port's ``Inference`` serves the parameters' current values, as the
JAX package's does (its ``infer`` reads ``parameters.as_dict()`` on every
call): after ``Parameters.set``, after ``SGD.train`` and after an in-place
edit, the same ``Inference`` object answers as a fresh one, and it copies
nothing while the weights stand still.

Tolerance against the JAX package: the logits' rtol 1e-4, atol 1e-5 of
``test_torch_slice.py`` (float32 through padding, two recurrences and a
max pooling). Port against port: equal bits.
"""

import jax
import numpy as np
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls

DICT, EMB, HID = 50, 16, 32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
OUT_W = "_output.w0"


def _models():
    with jax_name_scope():
        jm = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)
    with torch_name_scope():
        tm = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)
    return jm, tm      # (words, label, output, cost) each


def _init(jcost):
    jp = pj.parameters.create(jcost, rng=jax.random.PRNGKey(3))
    return {k: np.asarray(v) for k, v in jp.as_dict().items()}


def _rows(seed, B=6, labelled=False):
    r = np.random.RandomState(seed)
    lens = r.randint(1, 12, size=B)
    lens[0] = 11                     # every batch pads to T = 16
    rows = [r.randint(0, DICT, size=n).tolist() for n in lens]
    if labelled:
        return [(w, int(r.randint(0, 2))) for w in rows]
    return [(w,) for w in rows]


def test_inference_serves_weights_set_after_it_was_built():
    (_, _, jout, jcost), (_, _, tout, _) = _models()
    init = _init(jcost)
    assert OUT_W in init
    jp = pj.Parameters.from_dict(init)
    tp = TParameters.from_numpy(init)
    jinf = pj.Inference(jout, jp)
    tinf = pt.Inference(tout, tp, device="cpu")
    batch = _rows(1)
    first_j = jinf.infer(batch)
    first_t = tinf.infer(batch)
    np.testing.assert_allclose(first_t, first_j, **LOGIT_TOL)

    new_w = np.random.RandomState(2).randn(*init[OUT_W].shape) \
        .astype(np.float32)
    jp.set(OUT_W, new_w)
    tp.set(OUT_W, torch.from_numpy(new_w.copy()))
    second_j = jinf.infer(batch)
    second_t = tinf.infer(batch)
    assert not np.allclose(second_t, first_t, **LOGIT_TOL)
    np.testing.assert_allclose(second_t, second_j, **LOGIT_TOL)
    # __setitem__ is the same path
    tp[OUT_W] = torch.from_numpy(init[OUT_W].copy())
    np.testing.assert_array_equal(tinf.infer(batch), first_t)


def test_inference_serves_weights_trained_after_it_was_built():
    (_, _, jout, jcost), (_, _, tout, tcost) = _models()
    tp = TParameters.from_numpy(_init(jcost))
    inf = pt.Inference(tout, tp, device="cpu")
    batch = _rows(4)
    before = inf.infer(batch)
    batches = [_rows(s, B=4, labelled=True) for s in (5, 6)]
    trainer = pt.SGD(tcost, tp, pt.optimizer.Momentum(momentum=0.9,
                                                      learning_rate=0.5),
                     device="cpu")
    assert trainer.train(lambda: iter(batches), num_passes=1) is tp
    after = inf.infer(batch)
    fresh = pt.Inference(tout, tp, device="cpu").infer(batch)
    np.testing.assert_array_equal(after, fresh)
    assert not np.allclose(after, before, **LOGIT_TOL)
    # and the trained weights answer as the JAX package does on them
    jp = pj.Parameters.from_dict({k: v.numpy() for k, v in
                                  tp.as_dict().items()})
    np.testing.assert_allclose(after, pj.infer(output_layer=jout,
                                               parameters=jp, input=batch),
                               **LOGIT_TOL)


def test_inference_sees_in_place_edits_of_a_parameter():
    (_, _, _, jcost), (_, _, tout, _) = _models()
    tp = TParameters.from_numpy(_init(jcost))
    inf = pt.Inference(tout, tp, device="cpu")
    batch = _rows(7)
    before = inf.infer(batch)
    tp.get(OUT_W).mul_(-1.0)
    after = inf.infer(batch)
    np.testing.assert_array_equal(
        after, pt.Inference(tout, tp, device="cpu").infer(batch))
    assert not np.allclose(after, before, **LOGIT_TOL)


def test_inference_copies_nothing_while_weights_stand_still(monkeypatch):
    (_, _, _, jcost), (_, _, tout, _) = _models()
    tp = TParameters.from_numpy(_init(jcost))
    inf = pt.Inference(tout, tp, device="cpu")
    copies = []
    refresh = pt.Inference._refresh

    def counting_refresh(self):
        held = self._params
        refresh(self)
        copies.append(self._params is not held)

    monkeypatch.setattr(pt.Inference, "_refresh", counting_refresh)
    batch = _rows(8)
    for _ in range(3):
        inf.infer(batch)
    assert copies == [False, False, False]
    tp.set(OUT_W, tp.get(OUT_W) * 2)
    inf.infer(batch)
    inf.infer(batch)
    assert copies[3:] == [True, False]
