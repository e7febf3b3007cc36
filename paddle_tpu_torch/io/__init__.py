"""Serving artifacts (counterpart of ``paddle_tpu/io``): the per-tick
decode step export (``merged_model.export_decode_step_ex``)."""
