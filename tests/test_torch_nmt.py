"""The port's second slice end to end: the NMT attention model
(networks.gru_encoder_decoder) built small in paddle_tpu and in
paddle_tpu_torch, the JAX package's initial parameters carried over as
numpy, and both packages run on the same ragged source batches.

- Dense beam-search decode (models.text.nmt_decode_topology): equal ids
  from ``infer`` and in ``ctx.extras['m_gen:ids']``, scores allclose at
  rtol = atol = 1e-5, with and without early exit.
- The teacher-forced scoring form (nmt_attention_cost): probabilities
  allclose at rtol 1e-5 / atol 1e-6, and the cost.
- ``num_results_per_sample=2`` on a small hand-built beam_search.

Float32 on both sides; the products sum in another order, so scores and
probabilities differ in the last bits and the tolerances allow that. Ids
must be equal: the top-k keeps lax.top_k's tie order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_attention_cost as jax_nmt_cost
from paddle_tpu.models.text import nmt_decode_topology as jax_nmt_decode
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.models.text import nmt_attention_cost as torch_nmt_cost
from paddle_tpu_torch.models.text import \
    nmt_decode_topology as torch_nmt_decode
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder

SRC, TRG = 40, 30
WIDTHS = dict(word_vector_dim=16, encoder_size=32, decoder_size=32)
DECODE = dict(src_dict_dim=SRC, trg_dict_dim=TRG, beam_size=3, max_length=6,
              mode="dense", **WIDTHS)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
PROB_TOL = dict(rtol=1e-5, atol=1e-6)
EOS = 1


def _shapes(topology):
    return {n: tuple(s.shape) for n, s in topology.param_specs().items()}


def _jax_init(jtopo, seed, eos_bias=0.0):
    """The JAX package's initial parameters as numpy; ``eos_bias`` raises
    the output bias of eos so hypotheses end at different ticks."""
    d = {k: np.array(v) for k, v in
         jtopo.init_params(jax.random.PRNGKey(seed)).items()}
    if "_m_out.wbias" in d:
        d["_m_out.wbias"][EOS] += eos_bias
    return d


def _src_batches(seed):
    r = np.random.RandomState(seed)
    out = []
    for B in (5, 1, 7):
        lens = r.randint(1, 10, size=B)
        lens[0] = 9
        out.append([(r.randint(0, SRC, size=n).tolist(),) for n in lens])
    return out


def _forward_both(jtopo, ttopo, d, batch, feeding=None):
    jo, jctx = jtopo.forward({k: jnp.asarray(v) for k, v in d.items()},
                             JFeeder(jtopo.data_type(), feeding)(batch),
                             return_ctx=True)
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(ttopo.data_type(), feeding)(batch).items()}
    with torch.inference_mode():
        to, tctx = ttopo.forward({k: torch.from_numpy(v)
                                  for k, v in d.items()}, feeds,
                                 return_ctx=True)
    return (jo, jctx), (to, tctx)


def test_parameter_names_match_jax_in_both_forms():
    jgen = jax_nmt_decode(**DECODE)
    tgen = torch_nmt_decode(**DECODE)
    with jax_name_scope():
        jcost = jax_nmt_cost(SRC, TRG, **WIDTHS)
    with torch_name_scope():
        tcost = torch_nmt_cost(SRC, TRG, **WIDTHS)
    gen, cost = _shapes(pt.Topology(tgen)), _shapes(pt.Topology(tcost))
    assert gen == _shapes(pj.Topology(jgen))
    assert cost == _shapes(pj.Topology(jcost))
    # the shared names (_trg_emb, _m_dec_in.w0/.w1, the attention's) make
    # a scoring checkpoint serve the decoder
    assert {"_trg_emb", "_m_dec_in.w0", "_m_dec_in.w1",
            "_m_attn_weight.w0"} <= set(gen)
    assert {n: cost[n] for n in gen} == gen


@pytest.mark.parametrize("early_exit", [True, False])
def test_dense_decode_matches_jax(early_exit):
    jgen = jax_nmt_decode(early_exit=early_exit, **DECODE)
    tgen = torch_nmt_decode(early_exit=early_exit, **DECODE)
    jtopo, ttopo = pj.Topology(jgen), pt.Topology(tgen)
    d = _jax_init(jtopo, 0, eos_bias=2.0)
    jp, tp = pj.Parameters.from_dict(d), pt.Parameters.from_numpy(d)
    inf = pt.Inference(tgen, tp, device="cpu")
    keys = ("m_gen:ids", "m_gen:scores", "m_gen:ticks")

    @jax.jit
    def jax_extras(params, feeds):
        # jitted: the eager JAX beam loop takes seconds on the CPU
        _, ctx = jtopo.forward(params, feeds, return_ctx=True)
        return [ctx.extras[k] for k in keys]

    jparams = {k: jnp.asarray(v) for k, v in d.items()}
    tparams = {k: torch.from_numpy(v) for k, v in d.items()}
    ticks = []
    for batch in _src_batches(1):
        want = pj.infer(output_layer=jgen, parameters=jp, input=batch)
        got = inf.infer(batch)
        assert got.shape == (len(batch), DECODE["max_length"])
        np.testing.assert_array_equal(got, want)
        ids, scores, n = jax_extras(jparams, JFeeder(jtopo.data_type())(batch))
        feeds = {k: a.to("cpu") for k, a in
                 TFeeder(ttopo.data_type())(batch).items()}
        with torch.inference_mode():
            _, tctx = ttopo.forward(tparams, feeds, return_ctx=True)
        np.testing.assert_array_equal(tctx.extras["m_gen:ids"].numpy(),
                                      np.asarray(ids))
        np.testing.assert_allclose(tctx.extras["m_gen:scores"].numpy(),
                                   np.asarray(scores), **SCORE_TOL)
        assert tctx.extras["m_gen:ticks"] == int(n)
        ticks.append(tctx.extras["m_gen:ticks"])
    if early_exit:
        # the closed-form completion ran: some batch stopped early
        assert min(ticks) < DECODE["max_length"]


def test_scoring_form_matches_jax():
    with jax_name_scope():
        jcost = jax_nmt_cost(SRC, TRG, **WIDTHS)
    with torch_name_scope():
        tcost = torch_nmt_cost(SRC, TRG, **WIDTHS)
    assert tcost.type == "multi-class-cross-entropy"
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    d = _jax_init(jtopo, 4)
    r = np.random.RandomState(6)
    batch = []
    for n_src, n_trg in ((9, 7), (3, 1), (6, 8), (1, 4)):
        trg = r.randint(0, TRG, size=n_trg + 1).tolist()
        batch.append((r.randint(0, SRC, size=n_src).tolist(), trg[:-1],
                      trg[1:]))
    (jo, _), (to, _) = _forward_both(jtopo, ttopo, d, batch,
                                     {"src": 0, "trg": 1, "trg_next": 2})
    assert to["m_out"].value.shape == (len(batch), 8, TRG)
    np.testing.assert_array_equal(to["m_out"].mask.numpy(),
                                  np.asarray(jo["m_out"].mask))
    np.testing.assert_allclose(to["m_out"].value.numpy(),
                               np.asarray(jo["m_out"].value), **PROB_TOL)
    np.testing.assert_allclose(to["cost"].value.numpy(),
                               np.asarray(jo["cost"].value), **SCORE_TOL)


def _small_generator(mod, n_results):
    """src -> emb -> last_seq -> boot; step: fc([mem, token emb]) ->
    gru_step -> softmax, through the public beam_search."""
    src = mod.layer.data(name="src",
                         type=mod.data_type.integer_value_sequence(SRC))
    emb = mod.layer.embedding(input=src, size=8)
    boot = mod.layer.fc(input=mod.layer.last_seq(input=emb), size=8,
                        act=mod.activation.Tanh(), bias_attr=False,
                        name="boot")

    def step(cur):
        mem = mod.layer.memory(name="dec", size=8, boot_layer=boot)
        x = mod.layer.fc(input=[mem, cur], size=24,
                         act=mod.activation.Linear(), name="dec_x")
        h = mod.layer.gru_step(input=x, output_mem=mem, size=8, name="dec")
        return mod.layer.fc(input=h, size=TRG, act=mod.activation.Softmax(),
                            name="out")

    gen = mod.layer.GeneratedInput(size=TRG, embedding_name="_trg_emb",
                                   embedding_size=8, eos_id=EOS)
    return mod.layer.beam_search(step=step, input=[gen], beam_size=3,
                                 max_length=5, eos_id=EOS,
                                 num_results_per_sample=n_results,
                                 name="gen")


def test_num_results_per_sample_matches_jax():
    with jax_name_scope():
        jgen = _small_generator(pj, 2)
    with torch_name_scope():
        tgen = _small_generator(pt, 2)
    jtopo, ttopo = pj.Topology(jgen), pt.Topology(tgen)
    assert _shapes(ttopo) == _shapes(jtopo)
    r = np.random.RandomState(2)
    d = {n: (r.randn(*s) * 0.5).astype(np.float32)
         for n, s in sorted(_shapes(ttopo).items())}
    d["_out.wbias"][EOS] += 1.0
    batch = _src_batches(3)[2]
    (jo, _), (to, _) = _forward_both(jtopo, ttopo, d, batch)
    got, want = to["gen"], jo["gen"]
    assert got.value.shape == (len(batch), 2 * 5, 1)
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.seg_ids.numpy(),
                                  np.asarray(want.seg_ids))


def test_subsequence_input_group_runs_over_a_nested_src():
    """A SubsequenceInput group over a nested ``src`` (sentences of source
    ids) builds and runs as the JAX one does: the GRU step's memory starts
    again at each sentence, and the output keeps the sentences' seg_ids."""
    def build(mod):
        src = mod.layer.data(name="src",
                             type=mod.data_type.integer_value_sub_sequence(SRC))
        emb = mod.layer.embedding(input=src, size=8)
        proj = mod.layer.fc(input=emb, size=3 * 8, act=mod.activation.Linear())

        def step(x_t):
            m = mod.layer.memory(name="h", size=8)
            return mod.layer.gru_step(input=x_t, output_mem=m, size=8,
                                      name="h")
        return mod.layer.recurrent_group(
            step=step, input=[mod.layer.SubsequenceInput(input=proj)],
            name="group")

    with jax_name_scope():
        jgroup = build(pj)
    with torch_name_scope():
        tgroup = build(pt)
    jtopo, ttopo = pj.Topology(jgroup), pt.Topology(tgroup)
    assert _shapes(ttopo) == _shapes(jtopo)
    assert ttopo.info(tgroup).is_nested
    r = np.random.RandomState(3)
    d = {n: (r.randn(*s) * 0.5).astype(np.float32)
         for n, s in sorted(_shapes(ttopo).items())}
    batch = [([r.randint(0, SRC, size=n).tolist() for n in sents],)
             for sents in ([3, 2, 4], [1], [2, 2])]
    (jo, _), (to, _) = _forward_both(jtopo, ttopo, d, batch)
    got, want = to["group"], jo["group"]
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.seg_ids.numpy(),
                                  np.asarray(want.seg_ids))
