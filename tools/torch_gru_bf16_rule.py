"""Whether chip_smoke.py's check of the GRU kernels' bf16 forms tells the
bf16 rule apart from float32 arithmetic, on an NVIDIA GPU, at the RNN CRF
tagger's (32, 512, 128), ragged and with resets (the cluster kernels).

Runs chip_smoke.py's ``gru_bf16_kernels`` (its limits and controls: the
rule held where its operands are pinned, at least 99.9% bit-equal) on the
committed kernels, which must pass, then on a copy of ``gru_fwd.cu`` and
``gru_bwd.cu`` under build/ whose ``round_bf16`` returns its argument (the
products' operands, h_{t-1}, r*h_{t-1} and the pre-activation gradients,
left unrounded), which must be refused. Prints the card's name and power
limit first, each run's lines, then one JSON object.

    python3 tools/torch_gru_bf16_rule.py
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROUND = "return __bfloat162float(__float2bfloat16_rn(v));"


def unrounded_copy() -> Path:
    """csrc/ copied to build/gru_bf16_rule/csrc, round_bf16 an identity in
    both GRU sources."""
    from paddle_tpu_torch.kernels import _build

    d = ROOT / "build" / "gru_bf16_rule" / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    for name in ("gru_fwd.cu", "gru_bwd.cu"):
        src = (d / name).read_text()
        if src.count(ROUND) != 1:
            raise SystemExit(f"{name}: round_bf16's body is not in it once; "
                             f"update this tool")
        (d / name).write_text(src.replace(ROUND, "return v;"))
    return d


def use(csrc: Path) -> None:
    """Build and load the GRU kernels from ``csrc`` from here on."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import gru as tg

    _build.CSRC = csrc
    _build._libs.clear()
    for obj in vars(tg).values():
        if isinstance(obj, _build.GridKernel):
            obj._lib = None
    _build.build(["gru_fwd", "gru_bwd"])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gru_bf16_rule: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401
    from paddle_tpu_torch.kernels import _build

    print(cs.card_line(), flush=True)
    committed = _build.CSRC
    copy = unrounded_copy()
    use(committed)
    print("the committed kernels:", flush=True)
    rows = cs.gru_bf16_kernels(cs.GRU_CLUSTER_BF16_CASES,
                               cs.GRU_CLUSTER_BF16_KERNELS)
    use(copy)
    print("the copy with its operands unrounded:", flush=True)
    try:
        cs.gru_bf16_kernels(cs.GRU_CLUSTER_BF16_CASES[:1],
                            cs.GRU_CLUSTER_BF16_KERNELS)
    except SystemExit as refused:
        if "disagree with their plain versions" not in str(refused):
            raise
        verdict = f"refused: {refused}"
    else:
        print("the unrounded copy passes the check", file=sys.stderr)
        return 1
    print(f"  {verdict}", flush=True)
    print(json.dumps({"card": cs.card_line(), "committed": rows,
                      "unrounded": verdict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
