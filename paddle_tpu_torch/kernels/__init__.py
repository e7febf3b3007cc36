"""Hand-written Hopper kernels (counterpart of ``paddle_tpu/kernels``).

Each kernel is CUDA C++ in ``paddle_tpu_torch/csrc``, built at first use
(``_build``), with a plain PyTorch version beside its wrapper in the same
module. A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

``launches`` counts, per kernel, the launches its wrapper made, so a run
can show that its main path went through the kernel. ``reset_launches``
counts, of those, the recurrent kernels' launches that carried a segment
reset vector (packed rows, docs/packing.md).
"""

from __future__ import annotations

# csrc/<name>.cu of every kernel the port builds
SOURCES = ("lstm_fwd", "lstm_bwd", "gru_fwd", "gru_bwd", "crf", "ctc",
           "vocab_xent", "pool")

launches = {"fused_lstm": 0, "fused_lstm_bwd": 0, "fused_lstm_bwd_nodw": 0,
            "fused_lstm_bwd_dw": 0, "fused_lstm_bwd_dw_reduce": 0,
            "fused_lstm_bf16": 0, "fused_lstm_bwd_bf16": 0,
            "fused_lstm_bwd_nodw_bf16": 0, "fused_lstm_bwd_dw_bf16": 0,
            "fused_gru": 0, "fused_gru_cluster": 0, "fused_gru_bwd": 0,
            "fused_gru_bwd_cluster": 0, "fused_gru_bwd_dw": 0,
            "fused_gru_bwd_dw_reduce": 0, "fused_gru_bf16": 0,
            "fused_gru_bwd_bf16": 0, "fused_gru_bwd_dw_bf16": 0,
            "fused_gru_cluster_bf16": 0, "fused_gru_bwd_cluster_bf16": 0,
            "crf_fwd": 0, "crf_bwd": 0, "crf_bwd_marginals": 0,
            "crf_bwd_reduce": 0,
            "ctc_fwd": 0, "ctc_bwd": 0, "ctc_bwd_marginals": 0,
            "vocab_xent_fwd": 0, "vocab_xent_fwd_reduce": 0,
            "vocab_xent_bwd_dx": 0, "vocab_xent_bwd_dx_reduce": 0,
            "vocab_xent_bwd_dw": 0, "maxpool_bwd": 0, "maxpool_bwd_bf16": 0}

reset_launches = dict.fromkeys(launches, 0)


def count_launch(name: str, reset=None) -> None:
    """One launch of kernel ``name``, which took the reset vector
    ``reset`` (None: no reset)."""
    launches[name] += 1
    if reset is not None:
        reset_launches[name] += 1


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
        reset_launches[name] = 0
