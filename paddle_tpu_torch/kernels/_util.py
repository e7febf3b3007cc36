"""Constants the port's kernels share (the port's own copy of what it
needs from ``paddle_tpu/kernels/_pallas_util.py``).
"""

from __future__ import annotations

# finite stand-in for -inf in log space: a real -inf turns arithmetic
# mask blends into NaN (0 * -inf)
NEG = -1e30
