"""Trainer-side helpers (counterpart of ``paddle_tpu/trainer``); this slice
of the port has the DataFeeder."""
