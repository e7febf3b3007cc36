"""Times the port's ``vocab_xent_bwd_dw`` kernel against the number of
waves of its grid, on an NVIDIA GPU: the cost of the last, partial wave.

The kernel runs one block of 64 vocabulary columns an SM (its shared
memory allows no second), so at bench_nmt's output projection (bench.py:
245: N = 256 x 30, D = 512, V = 30000) its 469 blocks make 3.55 waves on
an H100's 132 SMs. This times it at N = 7680, D = 512 and V = 64 x SMs x k
for k = 1 to 4 (whole waves), and at V = 30000, with chip_smoke.py's
phase 9 inputs (numpy seed 1234). Prints the card's name and power limit,
a line a V, then one JSON object.

    python3 tools/torch_vocab_xent_dw_waves.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N, D, V_REPORT = 7680, 512, 30000
COLUMNS = 64  # csrc/vocab_xent.cu DW_BN
ITERS = 10


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_vocab_xent_dw_waves: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, card_line, cuda_ms, xent_inputs
    from paddle_tpu_torch.kernels import vocab_xent as tv

    card = card_line()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for V in sorted({COLUMNS * sms * k for k in (1, 2, 3, 4)} | {V_REPORT}):
        x, w, b, lab, ct = xent_inputs(N, D, V, "report", SEED)
        lse = tv.vocab_xent_plain(x, w, b, lab)[1]
        blocks = -(-V // COLUMNS)
        ms = cuda_ms(lambda: tv.vocab_xent_bwd_dw(x, w, b, lab, lse, ct),
                     ITERS)
        rows.append(dict(V=V, blocks=blocks, waves=blocks / sms, ms=ms,
                         ms_per_block_wave=ms / -(-blocks // sms)))
        print(f"  V={V:6d}: {blocks} blocks, {blocks / sms:.2f} waves on "
              f"{sms} SMs: {ms:.4f} ms ({ms / -(-blocks // sms):.4f} ms a "
              "started wave)", flush=True)
        del x, w, b, lab, ct, lse
    print(json.dumps(dict(card=card, N=N, D=D, sms=sms, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
