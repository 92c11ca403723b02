"""Where the time of one best-of-N generate call goes, on the GPU.

    python -m dyadic_interaction_modeling_tpu_torch.cli.profile_generate

Builds SLMFT at full width (``slm_defaults()`` + ``vq_listener_defaults()``,
random init from seed 0, bf16) and the main path's batch (25 synthetic clips
of L=256, best-of-10), runs one warmup generate, then one generate
under ``torch.profiler`` and one timed by host clock per stage (encode,
token loop, VQ decode, each ending in a synchronize). Prints the card's name
and power limit, the stage times, the device-busy share of the profiled call
(the union of its kernels' intervals over its wall time) and the kernels
with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import time

import torch

CLIPS, SAMPLES, LENGTH, SEED = 25, 10, 256, 0


def _busy_us(events) -> float:
    """Union length of the device intervals of ``events`` (microseconds)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def main() -> int:
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from ..config import slm_defaults, vq_listener_defaults
    from ..data.loader import PaddedBatchLoader, slm_batch_from_collated
    from ..data.synthetic import synthetic_vico_dataset
    from ..engine.pt_engine import make_slmft_generator
    from ..models.slm import SLMFT
    from ..models.xtrans import generate_tokens

    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])

    slm_cfg = slm_defaults()
    torch.manual_seed(SEED)
    model = SLMFT(slm_cfg, vq_listener_defaults()).to("cuda", torch.bfloat16).eval()
    ds = synthetic_vico_dataset(n_clips=CLIPS, min_len=LENGTH, max_len=LENGTH, seed=3)
    collated = next(iter(PaddedBatchLoader(ds, CLIPS, shuffle=False)))
    batch = tuple(torch.as_tensor(x, device="cuda")
                  for x in slm_batch_from_collated(collated))
    gen = make_slmft_generator(model)
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    n, length = SAMPLES, LENGTH

    gen(batch, rng, n)  # warmup
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(batch, rng, n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(kernels)
    print(f"profiled generate: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} kernels")
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / 1e3:9.2f} ms  {cnt:6d} x  {name[:100]}")

    with torch.no_grad():
        stages = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t) * 1e3
            return out

        ctx, prompt = stage("encode_context", lambda: model.encode_context(*batch))
        tokens = stage("token loop", lambda: generate_tokens(
            model.decoder, prompt.repeat(n, 1), length - 1, ctx, batch[3], rng,
            context_groups=n))
        stage("vq decode", lambda: model.decode_tokens_to_motion(tokens))
    steps = length - 1
    print("stages (host clock, synchronized): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; token loop {stages['token loop'] / steps * 1e3:.0f} us per token step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
