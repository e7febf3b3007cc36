"""Times two checkouts of the port against each other on one NVIDIA GPU:
the GRU dW kernel (``fused_gru_bwd_dw``, with its sum where it splits its
pairs) at the NMT encoder's (64, 100, 512) and the RNN CRF tagger's (32,
512, 128), the ``vocab_xent`` dx sum on [16, 512, 512] (the second
``vocab_xent`` main path's 16 slices), and the RNN CRF tagger's Adam
training step (models.text.rnn_crf_tagger at 5000/67/64/128, B=32, rows
256..512 long, T=512; the median of the last 4 of 6 steps).

Each measurement runs in a process of its own, with the checkout's root
first on sys.path, so each builds and imports its own paddle_tpu_torch; the
processes take turns: the other checkout, this one, this one, the other.
Every input comes from numpy seed 1234, the same in both. Kernel times
are device times: a spin (torch.cuda._sleep) holds the stream while the
host enqueues the calls. Prints the card's name and power limit, a line a
process, then one JSON object.

    python3 tools/torch_ab_checkouts.py OTHER_CHECKOUT
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 1234
ITERS = 20
DW_SHAPES = ((64, 100, 512), (32, 512, 128))
DX_SUM = (16, 512, 512)
TAGGER = dict(word_dim=5000, label_dim=67, emb_dim=64, hidden=128)
TAGGER_B, TAGGER_T, TAGGER_STEPS = 32, 512, 6


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of fn over iters calls, after one warm-up, the
    calls queued behind a spin of as long as one call took (at most 50
    ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(once * iters, 0.05) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dw_inputs(B, T, H, r):
    """dx3 (zero past each row's end), the z|r|c stash and hs of rows
    T/4..T long, on the card."""
    import torch

    lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    dx3 = (r.randn(B, T, 3 * H) * mask[..., None]).astype(np.float32)
    gates = r.rand(B, T, 3 * H).astype(np.float32)
    hs = np.tanh(r.randn(B, T, H)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (dx3, gates, hs)]


def tagger_step_ms(pt, r):
    """The median host time of the last 4 of TAGGER_STEPS Adam steps of
    rnn_crf_tagger through SGD.train (each step ends in a read of the
    cost, a device sync)."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import rnn_crf_tagger

    with layer_name_scope():
        cost = rnn_crf_tagger(**TAGGER)[3]
    weights = {}
    for name, spec in sorted(pt.Topology(cost).param_specs().items()):
        std = 0.1 if spec.is_bias else 1.0 / np.sqrt(spec.fan_in)
        weights[name] = (r.randn(*spec.shape) * std).astype(np.float32)
    batches = []
    for _ in range(TAGGER_STEPS):
        lens = r.randint(TAGGER_T // 2, TAGGER_T + 1, size=TAGGER_B)
        lens[0] = TAGGER_T
        batches.append([(r.randint(0, TAGGER["word_dim"], size=k).tolist(),
                         r.randint(0, TAGGER["label_dim"], size=k).tolist())
                        for k in lens])
    trainer = pt.SGD(cost, pt.Parameters.from_numpy(weights),
                     pt.optimizer.Adam(learning_rate=1e-3), device="cuda")
    ms = []

    def handler(ev):
        if isinstance(ev, pt.event.BeginIteration):
            ms.append(time.perf_counter())
        elif isinstance(ev, pt.event.EndIteration):
            ms[-1] = (time.perf_counter() - ms[-1]) * 1e3

    trainer.train(lambda: iter(batches), num_passes=1, event_handler=handler,
                  feeding={"words": 0, "labels": 1})
    return float(np.median(ms[-4:]))


def measure() -> dict:
    """This process's checkout's times, as one dict."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import gru as tg
    from paddle_tpu_torch.kernels import vocab_xent as tv

    r = np.random.RandomState(SEED)
    out = {}
    for B, T, H in DW_SHAPES:
        dx3, gates, hs = dw_inputs(B, T, H, r)
        out[f"fused_gru_bwd_dw {B}x{T}x{H}"] = cuda_ms(
            lambda: tg.fused_gru_bwd_dw(dx3, gates, hs))
    part = torch.from_numpy(r.randn(*DX_SUM).astype(np.float32)).cuda()
    out["vocab_xent_bwd_dx_reduce {}x{}x{}".format(*DX_SUM)] = cuda_ms(
        lambda: tv.vocab_xent_bwd_dx_reduce(part))
    out["rnn_crf_tagger Adam step"] = tagger_step_ms(pt, r)
    return out


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--measure":
        import torch

        if not torch.cuda.is_available():
            print("torch_ab_checkouts: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(measure()))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this = Path(__file__).resolve().parents[1]
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, "-c",
             "import runpy, sys; sys.path.insert(0, sys.argv[1]); "
             "sys.argv = [sys.argv[2], '--measure']; "
             "runpy.run_path(sys.argv[0], run_name='__main__')",
             str(root), str(Path(__file__).resolve())],
            cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"the {label} checkout's run failed")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(checkout=label, root=str(root), times=times))
        print(f"{label} ({root}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
