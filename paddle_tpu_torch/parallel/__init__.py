"""Parallel helpers (counterpart of ``paddle_tpu/parallel``). The port has
the single-device ``reference_attention`` so far; data, pipeline and
sequence parallelism come with their slices.
"""
