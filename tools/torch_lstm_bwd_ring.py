"""Times the port's LSTM backward recurrence (csrc/lstm_bwd.cu ``lstm_bwd``)
with its committed ring of dpre stages (NS = 2 stages of STAGE_F = 8192
floats) against the same source with 3 stages of 4096 floats, on one
NVIDIA GPU, in turns (committed, variant, variant, committed): the
evidence for the ring's two constants.

The variant is a copy of csrc/ under build/ with those two constants
changed, built by kernels/_build the same way (the library's name hashes
its source, so each build is its own). Inputs are drawn as chip_smoke.py
draws them (numpy seed 1234 + case, rows T/4..T long, every row T long in
the case "full"), and the forward kernel's outputs feed both; each dx4 is
held against the plain version's (within 1e-4 of its largest value) and
two launches must give the same bits. Times are device times (a spin holds
the stream while the host enqueues the calls). Prints the card's name
and power limit, a line a build and shape, then one JSON object.

    python3 tools/torch_lstm_bwd_ring.py
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

COMMITTED = ("constexpr int NS = 2;", "constexpr int STAGE_F = 8192;")
VARIANT = ("constexpr int NS = 3;", "constexpr int STAGE_F = 4096;")
CASES = [(64, 100, 512, "ragged"), (64, 128, 512, "ragged"),
         (1, 100, 512, "full"), (200, 30, 512, "ragged"),
         (2048, 8, 512, "ragged")]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_bwd_ring: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lstm as tl

    committed = _build.CSRC
    variant = ROOT / "build" / "lstm_bwd_ring"
    variant.mkdir(parents=True, exist_ok=True)
    for f in committed.glob("*.cuh"):
        shutil.copy(f, variant)
    src = (committed / "lstm_bwd.cu").read_text()
    for a, b in zip(COMMITTED, VARIANT):
        if a not in src:
            raise SystemExit(f"csrc/lstm_bwd.cu no longer has {a!r}")
        src = src.replace(a, b)
    (variant / "lstm_bwd.cu").write_text(src)
    builds = {"NS=2 x 8192 (committed)": committed,
              "NS=3 x 4096": variant}

    def use(csrc):
        _build.CSRC = csrc
        _build._libs.clear()
        tl._BWD._lib = None

    print(cs.card_line(), flush=True)
    args, want = {}, {}
    for i, (B, T, H, kind) in enumerate(CASES):
        r = np.random.RandomState(i)
        lengths = np.full(B, T) if kind == "full" else \
            np.maximum(1, r.randint(T // 4, T + 1, size=B))
        lengths[0] = T
        args[(B, T, H)] = cs.lstm_bwd_args(B, T, H, lengths, False,
                                           cs.SEED + i)
        want[(B, T, H)] = tl.fused_lstm_bwd_plain(*args[(B, T, H)])[0]
    out = {"card": cs.card_line(), "runs": []}
    names = list(builds)
    for name in names + names[::-1]:
        use(builds[name])
        times = {}
        for key, a in args.items():
            got = tl.fused_lstm_bwd_nodw(*a)
            again = tl.fused_lstm_bwd_nodw(*a)
            torch.cuda.synchronize()
            err = (got - want[key]).abs().max().item()
            if not (err <= 1e-4 * max(1.0, want[key].abs().max().item())
                    and torch.equal(got, again)):
                raise SystemExit(f"{name} at {key}: off the plain version "
                                 f"({err:.3e}) or two launches differ")
            ms = cs.cuda_ms(lambda: tl.fused_lstm_bwd_nodw(*a), 20)
            times[str(key)] = ms
            print(f"{name} (B, T, H) = {key}: {ms:.4f} ms, "
                  f"{ms * 1e3 / key[1]:.3f} us a step", flush=True)
        out["runs"].append(dict(build=name, times=times))
    use(committed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
