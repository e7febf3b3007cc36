"""The port's NMT training slice against the JAX package: the attention
model's training topology (models.text.nmt_attention_cost) built small in
both packages, the JAX package's initial parameters carried over as
numpy, and ``paddle_tpu_torch.SGD(...).train(device="cpu")`` against
``paddle_tpu.SGD(...).train(pipeline_depth=0)`` on the same
``dataset.synthetic.seq_pairs`` batches; and dropout inside a recurrent
group.

The JAX side trains through its lax.scan GRU (the CPU path of its layer)
and its scan over the decoder's step; the port through the fused_gru
Function's plain forward and backward and autograd across its eager tick
loop. Every batch pads to T=8 (``bucket_rounding=8``), so the JAX side
builds one step shape. Tolerances: costs rtol 1e-5; final parameters
rtol 1e-5 / atol 1e-6 with Momentum (linear in the gradient) and atol
1e-5 with Adam (g / sqrt(v) can turn float32 rounding of a tiny gradient
into a full-size step). Measured on these batches: costs within 1.2e-7
relative, parameters within 1.2e-7 (Momentum) and 2.9e-6 (Adam).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_attention_cost as jax_nmt_cost

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.models.text import nmt_attention_cost as torch_nmt_cost
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

SRC, TRG = 40, 30
WIDTHS = dict(word_vector_dim=16, encoder_size=32, decoder_size=32)
FEEDING = {"src": 0, "trg": 1, "trg_next": 2}
# seq_pairs with max_len 8: sources of 3..7 ids, targets of 4..8
MAX_LEN, ROUNDING = 8, 8

OPTIMIZERS = {
    "momentum": (lambda m: m.optimizer.Momentum(momentum=0.9,
                                                learning_rate=0.1),
                 dict(rtol=1e-5, atol=1e-6)),
    "adam": (lambda m: m.optimizer.Adam(learning_rate=5e-3),
             dict(rtol=0, atol=1e-5)),
}


def _models():
    with jax_name_scope():
        jcost = jax_nmt_cost(SRC, TRG, **WIDTHS)
    with torch_name_scope():
        tcost = torch_nmt_cost(SRC, TRG, **WIDTHS)
    return jcost, tcost


def _batches(n=3, B=6, seed=5):
    data = list(pt.dataset.synthetic.seq_pairs(SRC, TRG, n * B,
                                               max_len=MAX_LEN, seed=seed)())
    return [data[i * B:(i + 1) * B] for i in range(n)]


def _record(events):
    def handler(ev):
        events.append(ev)
    return handler


def test_seq_pairs_matches_jax():
    for kw in (dict(max_len=8, seed=5), dict(max_len=12, seed=0)):
        t = list(pt.dataset.synthetic.seq_pairs(SRC, TRG, 20, **kw)())
        j = list(pj.dataset.synthetic.seq_pairs(SRC, TRG, 20, **kw)())
        assert t == j and len(t) == 20
        for src, trg, nxt in t:
            assert len(trg) == len(src) + 1 and trg[0] == 0
            assert nxt == trg[1:] + [1]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_nmt_train_trajectory_matches_jax(opt):
    make_opt, param_tol = OPTIMIZERS[opt]
    jcost, tcost = _models()
    jtopo = pj.Topology(jcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(3)).items()}
    batches = _batches()
    reader = lambda: iter(batches)                      # noqa: E731
    kw = dict(num_passes=2, feeding=FEEDING, bucket_rounding=ROUNDING)

    jev, tev = [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), make_opt(pj))
    jtr.train(reader, event_handler=_record(jev), pipeline_depth=0, **kw)
    ttr = pt.SGD(tcost, TParameters.from_numpy(init), make_opt(pt),
                 device="cpu")
    ttr.train(reader, event_handler=_record(tev), **kw)

    jcosts = [e.cost for e in jev if isinstance(e, pj.event.EndIteration)]
    tcosts = [e.cost for e in tev if isinstance(e, pt.event.EndIteration)]
    assert len(tcosts) == len(jcosts) == 2 * len(batches)
    assert np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)
    assert tcosts[-1] < tcosts[0]
    jfinal = jtr.parameters.as_dict()
    tfinal = ttr.parameters.as_dict()
    assert sorted(tfinal) == sorted(jfinal) == sorted(init)
    for k in jfinal:
        np.testing.assert_allclose(tfinal[k].numpy(), np.asarray(jfinal[k]),
                                   err_msg=k, **param_tol)
        # every parameter trains: the encoder's GRUs and embedding get
        # their gradient through the recurrent group's StaticInputs, the
        # decoder's boot layer through its memory
        assert not np.array_equal(tfinal[k].numpy(), init[k]), \
            f"{k} never moved"


def test_training_encoder_takes_the_fused_gru_function():
    """In training both encoder directions run the fused_gru Function
    (their gradient is the backward kernels' on a card), not the
    generic loop."""
    _, tcost = _models()
    topo = pt.Topology(tcost)
    params = {k: v.requires_grad_(True) for k, v in
              topo.init_params().items()}
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(topo.data_type(), FEEDING)(_batches(1)[0]).items()}
    outs = topo.forward(params, feeds, training=True)
    grus = [l.name for l in topo.layers if l.type == "gated_recurrent"]
    assert grus == ["m_enc_fwd", "m_enc_bwd"]
    for name in grus:
        fn, seen = outs[name].value.grad_fn, set()
        stack = [fn]
        while stack:
            f = stack.pop()
            if f is None or f in seen:
                continue
            seen.add(f)
            stack.extend(n for n, _ in f.next_functions)
        assert "_FusedGRUBackward" in {type(f).__name__ for f in seen}


# --- dropout inside a recurrent group ---------------------------------------

def _dropout_group():
    """A recurrent group over embedded ids whose step's output layer drops
    half its units: h_t = dropout(tanh(fc([x_t, h_{t-1}])))."""
    ids = pt.layer.data(name="ids",
                        type=pt.data_type.integer_value_sequence(SRC))
    x = pt.layer.embedding(input=ids, size=6)

    def step(cur):
        mem = pt.layer.memory(name="h", size=8)
        return pt.layer.fc(input=[cur, mem], size=8,
                           act=pt.activation.Tanh(), name="h",
                           layer_attr=pt.attr.ExtraAttr(drop_rate=0.5))

    return pt.layer.recurrent_group(step=step, input=x, name="grp")


def test_recurrent_group_dropout_follows_training_flag():
    with torch_name_scope():
        grp = _dropout_group()
    topo = pt.Topology(grp)
    params = topo.init_params(torch.Generator().manual_seed(2))
    r = np.random.RandomState(0)
    feeds = {"ids": (torch.from_numpy(r.randint(0, SRC, (4, 5))),
                     torch.ones(4, 5))}

    def run(training, seed=None):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return topo.forward(params, feeds, training=training,
                            generator=g)["grp"].value

    plain = run(False)
    assert torch.equal(plain, run(False, seed=1))     # no drop, no draw
    a, b, c = run(True, 1), run(True, 1), run(True, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.2 < float(kept.float().mean()) < 0.8
    # the first tick's inputs are the same in both runs: the kept units
    # are the eval run's, scaled by 1 / keep
    torch.testing.assert_close(a[:, 0][kept[:, 0]],
                               2 * plain[:, 0][kept[:, 0]])
    # training inside the group draws from the outer forward's generator
    with pytest.raises(Error, match="generator"):
        run(True)
