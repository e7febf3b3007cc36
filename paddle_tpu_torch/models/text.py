"""RNN text models (counterpart of ``paddle_tpu/models/text.py``;
benchmark/paddle/rnn/{rnn.py,imdb.py} parity). The port has the stacked
LSTM classifier, the imikolov n-gram LM, the NMT attention model's
training (scoring) topology and its beam-search decode topology (dense,
selective and compact-K modes), the packing-ready NMT topology
(``nmt_packed_cost``, trained on padded or packed feeds), the two CRF
sequence taggers of v1_api_demo/sequence_tagging/{linear_crf,rnn_crf}.py,
and the CTR wide&deep model on sparse inputs, its tables on the device or
host-resident.
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


def ngram_lm(dict_dim=2000, emb_dim=32, hidden=128, context=4, name="ngram"):
    """imikolov n-gram LM (word embedding demo): N-1 context words ->
    softmax next-word. Each id arrives [B, 1], so the embeddings are
    [B, 1, emb_dim] and the output [B, 1, dict_dim], as in the JAX
    package."""
    ctx_words = [layer.data(name=f"w{i}",
                            type=data_type.integer_value(dict_dim))
                 for i in range(context)]
    nxt = layer.data(name="next_word", type=data_type.integer_value(dict_dim))
    embs = [layer.embedding(input=w, size=emb_dim,
                            param_attr=ParamAttr(name="_ngram_emb"))
            for w in ctx_words]
    merged = layer.concat(input=embs)
    h = layer.fc(input=merged, size=hidden, act=act.Relu())
    out = layer.fc(input=h, size=dict_dim, act=act.Linear(), name="output")
    cost = layer.classification_cost(input=out, label=nxt, name="cost")
    return ctx_words, nxt, out, cost


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


def ctr_wide_deep(wide_dim=10000, deep_vocab=10000, emb_dim=16, max_ids=32,
                  hidden=64, host_resident=False):
    """CTR wide&deep with sparse inputs (paddle/trainer/tests/
    simple_sparse_neural_network.py shape): wide: sparse binary ids ->
    embedding of width 1, summed by the output fc (the sparse fc analog);
    deep: sparse ids -> embedding -> fc. Both tables carry
    ``sparse_update``; the embedding layer does not join the sparse-row
    protocol (only selective_fc does), so they train through a dense
    gradient, as in the JAX package. ``host_resident=True`` marks both
    tables host-resident (docs/torch_embedding_cache.md): they never
    exist in device memory, the trainer stages a per-batch row cache
    instead, which lets ``deep_vocab`` go to 100M+ rows (bench.py --model
    ctr's host_big column)."""
    wide_in = layer.data(name="wide_ids",
                         type=data_type.sparse_binary_vector(wide_dim,
                                                             max_ids=max_ids))
    deep_in = layer.data(name="deep_ids",
                         type=data_type.sparse_binary_vector(deep_vocab,
                                                             max_ids=max_ids))
    lab = layer.data(name="click", type=data_type.integer_value(2))
    wide_emb = layer.embedding(
        input=wide_in, size=1,
        param_attr=ParamAttr(name="_wide_w", sparse_update=True,
                             host_resident=host_resident))
    # ids arrive [B, K]; embedding -> [B, K, 1]; resize -> [B, K]
    wide_feat = layer.resize(input=wide_emb, size=max_ids)
    deep_emb = layer.embedding(
        input=deep_in, size=emb_dim,
        param_attr=ParamAttr(name="_deep_emb", sparse_update=True,
                             host_resident=host_resident))
    deep_flat = layer.resize(input=deep_emb, size=max_ids * emb_dim)
    h = layer.fc(input=deep_flat, size=hidden, act=act.Relu())
    out = layer.fc(input=[h, wide_feat], size=2, act=act.Linear(),
                   name="output")
    cost = layer.classification_cost(input=out, label=lab, name="cost")
    return (wide_in, deep_in), lab, out, cost


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


def nmt_packed_cost(src_dict_dim=30000, trg_dict_dim=30000,
                    word_vector_dim=512, encoder_size=512,
                    decoder_size=512, num_heads=8, name="mp"):
    """The packing-ready NMT training topology, built from full-sequence
    layers only:

      src -> emb -> bi-GRU (simple_gru fwd/rev) -> concat -> enc proj
      trg -> emb -> GRU decoder state sequence
      multi_head_attention(query=dec states, kv=encoded)
      addto(dec, ctx) -> fc softmax over trg vocab -> per-token xent

    The port trains and serves it on padded feeds (one sample a row) and
    packed ones (``SGD.train(pack_sequences=True)``, docs/packing.md), its
    three GRUs through the fused_gru kernels, which on packed rows take
    the segment resets. Feeds: src / trg / trg_next integer sequences.
    Returns the cost layer; its input is the softmax output
    ``<name>_out``."""
    src = layer.data(name="src",
                     type=data_type.integer_value_sequence(src_dict_dim))
    trg = layer.data(name="trg",
                     type=data_type.integer_value_sequence(trg_dict_dim))
    lab = layer.data(name="trg_next",
                     type=data_type.integer_value_sequence(trg_dict_dim))
    src_emb = layer.embedding(input=src, size=word_vector_dim,
                              param_attr=ParamAttr(name="_src_emb"),
                              name=f"{name}_src_emb")
    enc_fwd = networks.simple_gru(input=src_emb, size=encoder_size,
                                  name=f"{name}_enc_fwd")
    enc_bwd = networks.simple_gru(input=src_emb, size=encoder_size,
                                  reverse=True, name=f"{name}_enc_bwd")
    encoded = layer.concat(input=[enc_fwd, enc_bwd], name=f"{name}_enc")
    enc_proj = layer.fc(input=encoded, size=decoder_size, act=act.Linear(),
                        bias_attr=False, name=f"{name}_enc_proj")
    trg_emb = layer.embedding(input=trg, size=word_vector_dim,
                              param_attr=ParamAttr(name="_trg_emb"),
                              name=f"{name}_trg_emb")
    dec = networks.simple_gru(input=trg_emb, size=decoder_size,
                              name=f"{name}_dec")
    ctx = layer.multi_head_attention(
        query=dec, key_value=enc_proj, size=decoder_size,
        num_heads=num_heads, causal=False, name=f"{name}_attn")
    combined = layer.addto(input=[dec, ctx], act=act.Tanh(),
                           bias_attr=False, name=f"{name}_comb")
    out = layer.fc(input=combined, size=trg_dict_dim, act=act.Softmax(),
                   name=f"{name}_out")
    return layer.classification_cost(input=out, label=lab, name="cost")


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
