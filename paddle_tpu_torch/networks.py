"""Network presets (counterpart of ``paddle_tpu/networks.py``; analog of
python/paddle/trainer_config_helpers/networks.py). The port has
``simple_lstm``, ``simple_gru``, ``simple_attention``,
``scaled_weighted_sum``, ``gru_encoder_decoder`` (dense, selective
and compact-K vocabulary projections), ``simple_img_conv_pool`` and
``img_conv_bn_pool``.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layer
from paddle_tpu_torch import pooling
from paddle_tpu_torch.attr import ParamAttr


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         name=None, pool_type=None, act=None, groups=1,
                         conv_stride=1, conv_padding=0, bias_attr=None,
                         num_channel=None, param_attr=None, shared_bias=True,
                         conv_layer_attr=None, pool_stride=1, pool_padding=0,
                         pool_layer_attr=None, img_size=None,
                         img_size_y=None):
    """img_conv then img_pool; the pool's geometry comes from the conv's
    inferred shape."""
    conv = layer.img_conv(input=input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channel,
                          stride=conv_stride, padding=conv_padding,
                          groups=groups, act=act, bias_attr=bias_attr,
                          param_attr=param_attr, shared_biases=shared_bias,
                          layer_attr=conv_layer_attr,
                          img_size=img_size, img_size_y=img_size_y,
                          name=name and f"{name}_conv")
    return layer.img_pool(input=conv, pool_size=pool_size,
                          pool_type=pool_type, stride=pool_stride,
                          padding=pool_padding, layer_attr=pool_layer_attr,
                          name=name and f"{name}_pool")


def img_conv_bn_pool(input, filter_size, num_filters, pool_size, name=None,
                     pool_type=None, act=None, groups=1, conv_stride=1,
                     conv_padding=0, conv_bias_attr=None, num_channel=None,
                     conv_param_attr=None, shared_bias=True,
                     conv_layer_attr=None, bn_param_attr=None,
                     bn_bias_attr=None, bn_layer_attr=None, pool_stride=1,
                     pool_padding=0, pool_layer_attr=None, img_size=None,
                     img_size_y=None):
    """img_conv (linear: the reference passes LinearActivation, where the
    img_conv wrapper would default to Relu), batch_norm with ``act``,
    then img_pool."""
    conv = layer.img_conv(input=input, filter_size=filter_size,
                          num_filters=num_filters, num_channels=num_channel,
                          stride=conv_stride, padding=conv_padding,
                          groups=groups, act=act_linear(),
                          bias_attr=conv_bias_attr,
                          param_attr=conv_param_attr,
                          shared_biases=shared_bias,
                          layer_attr=conv_layer_attr, img_size=img_size,
                          img_size_y=img_size_y,
                          name=name and f"{name}_conv")
    bn = layer.batch_norm(input=conv, act=act, num_channels=num_filters,
                          param_attr=bn_param_attr, bias_attr=bn_bias_attr,
                          layer_attr=bn_layer_attr,
                          name=name and f"{name}_bn")
    return layer.img_pool(input=bn, pool_size=pool_size,
                          pool_type=pool_type, stride=pool_stride,
                          padding=pool_padding, name=name and f"{name}_pool")


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


def simple_gru(input, size, name=None, reverse=False, mixed_param_attr=None,
               mixed_bias_param_attr=None, gru_param_attr=None,
               gru_bias_attr=None, act=None, gate_act=None, **kw):
    """fc(3*size, identity act, no bias) -> grumemory."""
    mix = layer.fc(input=input, size=size * 3, act=act_linear(),
                   param_attr=mixed_param_attr, bias_attr=False,
                   name=name and f"{name}_transform")
    return layer.grumemory(input=mix, name=name, reverse=reverse,
                           param_attr=gru_param_attr, bias_attr=gru_bias_attr,
                           act=act, gate_act=gate_act)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None):
    """Bahdanau-style additive attention built from primitive layers:
    expand the decoder state over the source sequence, add, tanh, score
    fc, sequence softmax, weighted sum."""
    expanded = layer.expand(input=decoder_state, expand_as=encoded_sequence,
                            name=name and f"{name}_expand")
    combined = layer.addto(input=[encoded_proj, expanded],
                           act=act.Tanh(), bias_attr=False,
                           name=name and f"{name}_combine")
    scores = layer.fc(input=combined, size=1, act=act.SequenceSoftmax(),
                      bias_attr=False, param_attr=softmax_param_attr,
                      name=name and f"{name}_weight")
    return scaled_weighted_sum(encoded_sequence, scores,
                               name=name and f"{name}_ctx")


def scaled_weighted_sum(seq, weights, name=None):
    scaled = layer.scaling(input=seq, weight=weights,
                           name=name and f"{name}_scaled")
    return layer.pooling(input=scaled, pooling_type=pooling.Sum(), name=name)


def gru_encoder_decoder(src_word_id, trg_embedding=None, src_dict_dim=30000,
                        trg_dict_dim=30000, word_vector_dim=512,
                        encoder_size=512, decoder_size=512,
                        is_generating=False, beam_size=3, max_length=25,
                        bos_id=0, eos_id=1, name="gru_encdec",
                        trg_vocab_select=None, vocab_select_gather_min=None,
                        compact_decode=True, early_exit=True):
    """Attention seq2seq: bidirectional GRU encoder, Bahdanau attention,
    GRU decoder via recurrent_group; generation via beam_search.

    Scoring mode returns the per-step probability sequence (feed
    trg_embedding = embedding of the <s>-prefixed target); generation mode
    returns the beam_search layer. Layer and parameter names are the JAX
    package's, so checkpoints move between the two and between the modes.

    ``trg_vocab_select``: an optional [B, K] layer of candidate vocab ids
    a sentence (-1 padded). The vocab projection becomes a selective_fc
    over those rows, named and laid out like the dense fc
    (weight_transposed), so checkpoints move between the modes; other
    tokens score -1e30, so emitted ids lie in the candidate set. In
    scoring mode the projection runs once over the [B, T, H] hidden
    sequence with the selection applied at every step (labels must then
    lie in the set). ``vocab_select_gather_min`` overrides the gather
    path's crossover (0 forces it). ``compact_decode`` (generation with
    ``trg_vocab_select``): the beam scores in candidate space, [B*beam,
    K], and maps the winners to vocab ids at emission; candidate rows
    must then contain eos_id. ``compact_decode=False`` scatters the
    selective projection to [B*beam, V] (the selective mode).
    """
    src_emb = layer.embedding(input=src_word_id, size=word_vector_dim,
                              param_attr=ParamAttr(name="_src_emb"),
                              name=f"{name}_src_emb")
    enc_fwd = simple_gru(input=src_emb, size=encoder_size,
                         name=f"{name}_enc_fwd")
    enc_bwd = simple_gru(input=src_emb, size=encoder_size, reverse=True,
                         name=f"{name}_enc_bwd")
    encoded = layer.concat(input=[enc_fwd, enc_bwd], name=f"{name}_enc")
    encoded_proj = layer.fc(input=encoded, size=decoder_size,
                            act=act_linear(), bias_attr=False,
                            name=f"{name}_enc_proj")
    backward_first = layer.first_seq(input=enc_bwd)
    decoder_boot = layer.fc(input=backward_first, size=decoder_size,
                            act=act.Tanh(), bias_attr=False,
                            name=f"{name}_boot")

    def vocab_proj(hidden, select, compact=False):
        """The dense fc, or a selective_fc over candidate ids with the same
        layer name and parameters."""
        if select is None:
            return layer.fc(input=hidden, size=trg_dict_dim,
                            act=act.Softmax(), name=f"{name}_out")
        return layer.selective_fc(
            input=hidden, select=select, size=trg_dict_dim,
            act=act.Softmax(), name=f"{name}_out",
            select_is_id_list=True, weight_transposed=True,
            select_unique=True,      # candidate lists: unique by contract
            compact_output=compact,
            gather_min_c=vocab_select_gather_min)

    def make_step(project_out, emb_preprojected=False, with_select=False):
        def step(*args):
            if with_select:
                enc_seq, enc_proj, cand, cur_emb = args
            else:
                (enc_seq, enc_proj, cur_emb), cand = args, None
            dec_mem = layer.memory(name=f"{name}_dec", size=decoder_size,
                                   boot_layer=decoder_boot)
            context = simple_attention(encoded_sequence=enc_seq,
                                       encoded_proj=enc_proj,
                                       decoder_state=dec_mem,
                                       name=f"{name}_attn")
            if emb_preprojected:
                # cur_emb is already cur_emb @ W1 (hoisted out of the
                # loop below); only the context half of the two-input fc
                # stays per tick. Shared parameter names keep checkpoints
                # portable between the modes.
                ctx_proj = layer.fc(
                    input=context, size=decoder_size * 3, act=act_linear(),
                    bias_attr=False, name=f"{name}_dec_in",
                    param_attr=ParamAttr(name=f"_{name}_dec_in.w0"))
                dec_inputs = layer.addto(input=[ctx_proj, cur_emb],
                                         bias_attr=False,
                                         name=f"{name}_dec_in_sum")
            else:
                dec_inputs = layer.fc(input=[context, cur_emb],
                                      size=decoder_size * 3,
                                      act=act_linear(), bias_attr=False,
                                      name=f"{name}_dec_in")
            gru = layer.gru_step(input=dec_inputs, output_mem=dec_mem,
                                 size=decoder_size, name=f"{name}_dec")
            if not project_out:
                return gru
            return vocab_proj(gru, cand,
                              compact=with_select and compact_decode)
        return step

    enc_in = layer.StaticInput(input=encoded)
    proj_in = layer.StaticInput(input=encoded_proj)
    if not is_generating:
        # the target-embedding half of the dec_in projection does not
        # depend on the tick: one [B, T, D] @ W1 product outside the loop
        # (weight shared by name with the generation step's two-input fc),
        # and the vocab projection runs once over the [B, T, H] hidden
        # sequence
        emb_proj = layer.fc(
            input=trg_embedding, size=decoder_size * 3, act=act_linear(),
            bias_attr=False, name=f"{name}_emb_proj",
            param_attr=ParamAttr(name=f"_{name}_dec_in.w1"))
        hidden_seq = layer.recurrent_group(
            step=make_step(False, emb_preprojected=True),
            input=[enc_in, proj_in, emb_proj], name=f"{name}_decoder")
        # a [B, K] selection applies at every step of the [B, T, H] hidden
        # sequence
        return vocab_proj(hidden_seq, trg_vocab_select)
    gen_inputs = [enc_in, proj_in]
    if trg_vocab_select is not None:
        gen_inputs.append(layer.StaticInput(input=trg_vocab_select,
                                            is_seq=False))
    gen_inputs.append(layer.GeneratedInput(size=trg_dict_dim,
                                           embedding_name="_trg_emb",
                                           embedding_size=word_vector_dim,
                                           bos_id=bos_id, eos_id=eos_id))
    return layer.beam_search(
        step=make_step(True, with_select=trg_vocab_select is not None),
        input=gen_inputs, bos_id=bos_id, eos_id=eos_id, beam_size=beam_size,
        max_length=max_length, name=f"{name}_gen", early_exit=early_exit)
