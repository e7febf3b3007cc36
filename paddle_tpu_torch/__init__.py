"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths and public names, and never imports JAX or ``paddle_tpu``.
Plain tensor code is PyTorch; each Pallas TPU kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use.

Ported so far: inference of the LSTM text classifier
(``models.text.lstm_text_classification``) through ``infer``, with the
``fused_lstm`` forward kernel, and its training through ``SGD(...).train``
with the ``fused_lstm`` backward kernels, the dense optimizers, the v2
events, ``evaluator.classification_error`` and the readers; the NMT
attention model's dense beam-search decode
(``models.text.nmt_decode_topology(mode="dense")``) and its teacher-forced
scoring form, with the ``fused_gru`` forward kernel; and the parameter tar
format shared with ``paddle_tpu``; later slices the rest of the text,
tagging, CTC and serving paths, and the image slice (convolutions, pools,
batch norm with its moving statistics, ``SGD(mixed_precision=True)``,
``models.resnet`` and ``models.image_bench``). Entry points run on
``device="cuda"`` unless the caller asks for the CPU.
"""

from paddle_tpu_torch import activation
from paddle_tpu_torch import attr
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer
from paddle_tpu_torch import networks
from paddle_tpu_torch import pooling
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology, topology_from_config
from paddle_tpu_torch.inference import Inference, infer
from paddle_tpu_torch import dataset
from paddle_tpu_torch import evaluator
from paddle_tpu_torch import initializer
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import reader
from paddle_tpu_torch.core import parameters
from paddle_tpu_torch.core.parameters import create as parameters_create
from paddle_tpu_torch.dataset import synthetic as _synthetic  # noqa: F401
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.trainer import event

batch = reader.minibatch_batch
