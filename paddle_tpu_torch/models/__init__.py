"""Model configurations (counterpart of ``paddle_tpu/models``)."""
