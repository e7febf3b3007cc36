"""Measures what a step of a thread-block-cluster recurrence costs on the
card beside its arithmetic: a cluster barrier (``cluster.sync()``), the
exchange of csrc/gru_fwd.cu's cluster kernel (each block's run of n
floats copied into the cluster's other blocks' shared memory, 16 bytes a
store, then the barrier), the exchange with one store a thread to device
memory before the barrier, and a block barrier, at C = 2, 4, 8 and 16
blocks a cluster, with one cluster and with 8 clusters on the card at
once. n = 64 is the RNN CRF tagger's run at C = 8 (16 units x 4 rows).
Builds tools/cluster_step_cost.cu with nvcc into build/, prints the
card's name and power limit, a line a setting (ns a step), then one JSON
object.

    python3 tools/torch_cluster_step_cost.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ITERS = 4096
MODES = {0: "cluster.sync", 1: "exchange + cluster.sync",
         2: "__syncthreads",
         3: "exchange + a device-memory store + cluster.sync"}
CLUSTERS = (2, 4, 8, 16)
RUNS = (16, 64, 256)


def build() -> ctypes.CDLL:
    from paddle_tpu_torch.kernels import _build

    out = ROOT / "build" / "tools" / "libcluster_step_cost.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "cluster_step_cost.cu")], check=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cluster_step_cost.argtypes = [P, P, I, I, I, I, I, P]
    lib.cluster_step_cost.restype = I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cluster_step_cost: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, cuda_ms

    card = card_line()
    print(card)
    lib = build()
    out = torch.empty(16 * 8, device="cuda")
    sink = torch.empty(16 * 8 * ITERS * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode, C, clusters, n):
        err = lib.cluster_step_cost(out.data_ptr(), sink.data_ptr(), mode, C,
                                    clusters, ITERS, n, stream)
        if err:
            raise SystemExit(f"cluster_step_cost launch failed: {err}")

    rows = []
    for C in CLUSTERS:
        for clusters in (1, 8):
            for mode, name in MODES.items():
                for n in (RUNS if mode == 1 else (64,)):
                    ns = cuda_ms(lambda: run(mode, C, clusters, n), 5) \
                        * 1e6 / ITERS
                    rows.append(dict(C=C, clusters=clusters, mode=name, n=n,
                                     ns_a_step=ns))
                    print(f"  C={C:2d} clusters={clusters} {name}"
                          + (f" (n={n})" if mode in (1, 3) else "")
                          + f": {ns:.1f} ns a step", flush=True)
    print(json.dumps(dict(card=card, iters=ITERS, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
