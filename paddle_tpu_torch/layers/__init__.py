"""Layer type implementations (counterpart of ``paddle_tpu/layers``).
Importing this package registers every ported layer type into
LAYER_REGISTRY; the user-facing wrappers live in paddle_tpu_torch.layer.
"""

from paddle_tpu_torch.layers import attention   # noqa: F401
from paddle_tpu_torch.layers import basic       # noqa: F401
from paddle_tpu_torch.layers import conv        # noqa: F401
from paddle_tpu_torch.layers import cost        # noqa: F401
from paddle_tpu_torch.layers import crf_ctc     # noqa: F401
from paddle_tpu_torch.layers import math_ops    # noqa: F401
from paddle_tpu_torch.layers import misc        # noqa: F401
from paddle_tpu_torch.layers import norm        # noqa: F401
from paddle_tpu_torch.layers import recurrent   # noqa: F401
from paddle_tpu_torch.layers import recurrent_group  # noqa: F401
from paddle_tpu_torch.layers import sequence    # noqa: F401
