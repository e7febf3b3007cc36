"""Utilities (counterpart of ``paddle_tpu/utils``)."""
