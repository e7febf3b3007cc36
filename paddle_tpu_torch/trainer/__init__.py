"""Trainer (counterpart of ``paddle_tpu/trainer``): the DataFeeder, the
v2 events and the SGD train loop."""

from paddle_tpu_torch.trainer import event
from paddle_tpu_torch.trainer.trainer import SGD, make_train_step
