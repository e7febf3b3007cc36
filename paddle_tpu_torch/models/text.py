"""RNN text models (counterpart of ``paddle_tpu/models/text.py``;
benchmark/paddle/rnn/{rnn.py,imdb.py} parity). The port has the stacked
LSTM classifier, the NMT attention model's training (scoring) topology
and its beam-search decode topology (dense, selective and compact-K
modes), and the two CRF sequence taggers of
v1_api_demo/sequence_tagging/{linear_crf,rnn_crf}.py.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import data_type, layer, networks, pooling
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.utils.error import enforce


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


def linear_crf_tagger(word_dim=5000, label_dim=67, emb_dim=32,
                      context_len=5):
    """v1_api_demo/sequence_tagging/linear_crf.py: context-window features
    -> linear projection -> CRF; the decoder shares the cost's weights."""
    words = layer.data(name="words",
                       type=data_type.integer_value_sequence(word_dim))
    labels = layer.data(name="labels",
                        type=data_type.integer_value_sequence(label_dim))
    emb = layer.embedding(input=words, size=emb_dim)
    ctx = layer.mixed(
        size=emb_dim * context_len,
        input=[layer.context_projection(emb, context_len)])
    feat = layer.fc(input=ctx, size=label_dim, act=act.Linear(),
                    bias_attr=False, name="crf_feat")
    cost = layer.crf(input=feat, label=labels, size=label_dim, name="crf_cost")
    decode = layer.crf_decoding(input=feat, size=label_dim,
                                param_attr=ParamAttr(name="_crf_cost.w0"),
                                name="crf_decode")
    return words, labels, feat, cost, decode


def rnn_crf_tagger(word_dim=5000, label_dim=67, emb_dim=64, hidden=128):
    """v1_api_demo/sequence_tagging/rnn_crf.py: bidirectional GRU features
    -> CRF."""
    words = layer.data(name="words",
                       type=data_type.integer_value_sequence(word_dim))
    labels = layer.data(name="labels",
                        type=data_type.integer_value_sequence(label_dim))
    emb = layer.embedding(input=words, size=emb_dim)
    fwd = networks.simple_gru(input=emb, size=hidden, name="rnncrf_fwd")
    bwd = networks.simple_gru(input=emb, size=hidden, reverse=True,
                              name="rnncrf_bwd")
    feat = layer.fc(input=[fwd, bwd], size=label_dim, act=act.Linear(),
                    bias_attr=False, name="crf_feat")
    cost = layer.crf(input=feat, label=labels, size=label_dim, name="crf_cost")
    return words, labels, feat, cost


def nmt_attention_cost(src_dict_dim=30000, trg_dict_dim=30000,
                       word_vector_dim=512, encoder_size=512,
                       decoder_size=512, name="m"):
    """The NMT training topology: bidirectional-GRU encoder +
    Bahdanau-attention GRU decoder (networks.gru_encoder_decoder) with
    teacher forcing and per-token cross entropy. Feeds: src / trg /
    trg_next integer sequences. Returns the cost layer; ``SGD.train``
    trains it (the encoder's two GRUs through the fused_gru kernels and
    their backward, the decoder's tick loop through autograd)."""
    src = layer.data(name="src",
                     type=data_type.integer_value_sequence(src_dict_dim))
    trg = layer.data(name="trg",
                     type=data_type.integer_value_sequence(trg_dict_dim))
    lab = layer.data(name="trg_next",
                     type=data_type.integer_value_sequence(trg_dict_dim))
    emb = layer.embedding(input=trg, size=word_vector_dim,
                          param_attr=ParamAttr(name="_trg_emb"),
                          name=f"{name}_trg_emb")
    probs = networks.gru_encoder_decoder(
        src_word_id=src, trg_embedding=emb, src_dict_dim=src_dict_dim,
        trg_dict_dim=trg_dict_dim, word_vector_dim=word_vector_dim,
        encoder_size=encoder_size, decoder_size=decoder_size, name=name)
    return layer.classification_cost(input=probs, label=lab, name="cost")


def nmt_decode_topology(src_dict_dim=30000, trg_dict_dim=30000,
                        word_vector_dim=512, encoder_size=512,
                        decoder_size=512, beam_size=4, max_length=16,
                        cand_k=1024, mode="compact", early_exit=True,
                        name="m"):
    """The NMT generation topology: the training preset's encoder/decoder
    in beam-search generation mode, the decode path chosen by ``mode``
    (docs/decode.md):

      dense     — full-vocab projection, beam over [B*beam, V]
      selective — selective_fc gather projection scattered to
                  [B*beam, V], beam still over the vocab
      compact   — compact-K: projection and beam in candidate space

    Feeds: ``src`` integer sequence; plus ``cand`` ([B, cand_k] unique
    candidate ids containing eos, a dense_vector) for selective/compact.
    Returns the beam_search generation layer; decode ids/scores/ticks land
    in ctx.extras['<name>_gen:ids'/':scores'/':ticks']."""
    from paddle_tpu_torch.core.layer import layer_name_scope

    enforce(mode in ("dense", "selective", "compact"),
            f"nmt_decode_topology: unknown mode {mode!r}")
    with layer_name_scope():
        src = layer.data(name="src",
                         type=data_type.integer_value_sequence(src_dict_dim))
        sel = None
        if mode != "dense":
            sel = layer.data(name="cand",
                             type=data_type.dense_vector(cand_k))
        return networks.gru_encoder_decoder(
            src_word_id=src, src_dict_dim=src_dict_dim,
            trg_dict_dim=trg_dict_dim, word_vector_dim=word_vector_dim,
            encoder_size=encoder_size, decoder_size=decoder_size,
            is_generating=True, beam_size=beam_size, max_length=max_length,
            name=name, trg_vocab_select=sel, vocab_select_gather_min=0,
            compact_decode=(mode == "compact"), early_exit=early_exit)
