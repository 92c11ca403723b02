"""Wall-clock and host time of a VQ-VAE training step, on the GPU.

    python -m dyadic_interaction_modeling_tpu_torch.cli.time_vq_step [--speaker]
        [--steps 30] [--rounds 3]

Builds the listener VQ-VAE (``vq_listener_defaults()``), or with
``--speaker`` the audio-visual speaker VQ-VAE (``vq_speaker_defaults()``), at
full width from seed 0 in fp32, with AdamW (lr 1e-4, weight decay 0.01, as
``train_vq``) and one synthetic clip of 1024 frames, as ``chip_smoke.py``'s
VQ phases do. After five warmup steps, each round runs ``--steps`` steps back
to back and prints two numbers:

- step: the round's wall-clock time a step, from the first call to the
  synchronize after the last;
- host: the median time a step call takes to return. The step never waits
  for the card, so this is the host's time to issue the step's work; where
  it is close to the step time, the host sets the pace.

Before the rounds it prints the host's side of one differentiated K2 + K3
call at the model's attention shape, (8, 1024, 48) or (8, 1024, 96) fp32:
the median time, over 50 calls each started on an idle card, from the call
until ``backward`` returns. Prints the card's name and power limit first.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

FRAMES, SEED = 1024, 0


def _clip(speaker: bool) -> torch.Tensor:
    """One synthetic clip of FRAMES frames as the VQ collate gives it: the
    listener's motion, and for the speaker VQ its audio features after it."""
    from ..data.loader import vq_collate
    from ..data.synthetic import synthetic_vico_dataset

    combined, listener = synthetic_vico_dataset(n_clips=1, min_len=FRAMES, max_len=FRAMES,
                                                seed=11)[0][:2]
    if not speaker:
        return torch.as_tensor(vq_collate([(listener,)]), device="cuda")
    clip = torch.cat([torch.as_tensor(listener), torch.as_tensor(combined[:, 56:])], dim=1)
    return clip[None].to("cuda")


def _quartiles(xs, unit: str = "ms") -> str:
    q = [x * (1e3 if unit == "ms" else 1e6) for x in statistics.quantiles(xs, n=4)]
    return f"median {q[1]:.2f} {unit} (quartiles {q[0]:.2f}-{q[2]:.2f})"


def _attention_call_host(d: int, calls: int = 50) -> list:
    """Host seconds of ``calls`` differentiated K2 + K3 calls at (8, FRAMES,
    d) fp32, each started with the card idle."""
    from ..kernels.attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(8, FRAMES, d, device="cuda", generator=g).requires_grad_()
               for _ in range(3))
    grad = torch.randn(8, FRAMES, d, device="cuda", generator=g)
    host = []
    for i in range(calls + 5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        flash_attention(q, k, v, scale=d ** -0.5).backward(grad)
        if i >= 5:
            host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return host


def main(argv=None) -> int:
    from ..config import vq_listener_defaults, vq_speaker_defaults
    from ..engine.train_state import make_optimizer
    from ..engine.vq_engine import make_vq_train_step
    from ..models.vq_vae import VQAutoEncoder, VQSpeakerAutoEncoder

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--speaker", action="store_true")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_vq_step needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    d = 96 if args.speaker else 48
    print(f"K2 + K3 call (8, {FRAMES}, {d}) fp32, host: "
          f"{_quartiles(_attention_call_host(d), 'us')}")
    torch.manual_seed(SEED)
    model = (VQSpeakerAutoEncoder(vq_speaker_defaults()) if args.speaker
             else VQAutoEncoder(vq_listener_defaults())).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01),
                              audio_visual=args.speaker)
    clip = _clip(args.speaker)
    for _ in range(5):
        step(clip)
    torch.cuda.synchronize()
    what = "speaker VQ" if args.speaker else "VQ"
    for r in range(args.rounds):
        host = []
        t0 = time.perf_counter()
        for _ in range(args.steps):
            t = time.perf_counter()
            step(clip)
            host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        print(f"{what} train step B=1 L={FRAMES} fp32, round {r}: step {wall * 1e3:.2f} ms, "
              f"host {_quartiles(host)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
