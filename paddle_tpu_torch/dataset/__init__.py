"""Datasets (counterpart of ``paddle_tpu/dataset``); the port has the
deterministic synthetic generators."""
