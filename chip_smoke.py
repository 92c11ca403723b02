#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version, drive SLMFT best-of-10 listener generation
(multi-head and grouped-query), the SLM pretraining step, the listener and
speaker VQ-VAE tokenizers' training steps and the SLMFT finetune step at full
width, then the four CLI twins on files in the reference's layout, then the
BIWI speaker family (SpeakerSLMFT best-of-50 generation, the test_biwi twin,
its finetune step, the converter's training twin), then the seq2seq
ListenerGenerator path (its training step, the test_s2s loop, the
train_s2s / test_s2s twins on files), the streaming serving sessions
(listener session, session pool, speaker session), then the speech path
(the wav2vec2 / HuBERT trunk, CodeTalker's training step and predict,
train_stage2 and test_biwi --data-root on BIWI files, the streaming audio
front-end), then the PIRender inference path (FaceGenerator at full width,
render_clip, the render_inference and intuitive_control twins), then the live
avatar chain (the fused and the composable pipeline at bench.py's avatar
shape), then PIRender's training (both stages, the render_train twin) and the
``--mesh`` layouts on one card, and time it all.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each prints its own lines; any failure exits 1 without the final
line):

1. device: the card's name and power limit as nvidia-smi prints them;
2. build: ``torch.utils.cpp_extension.load`` of every source in ``csrc/``
   (sm_90a), timed, and beside it ``nvcc -Xptxas -v`` of
   ``flash_attention.cu`` alone: one line of registers and spills for every
   fp32 K2/K3 instantiation;
3. K4 ``nearest_code`` at (6400, 128) x (512, 128) fp32: exact indices on
   inputs with a margin, >= 99.9% agreement on plain random inputs, a NaN
   latent gets code 0; the same at the SLM training step's (8192, 128), at
   the VQ training and finetune steps' (1024, 128), and at N and n_e that
   are not multiples of the kernel's tiles;
4. K1 ``decode_attention`` in fp32 (tolerance 1e-5) and bf16 (2e-2): the
   self case (3000, 1, 64) x L=256, MQA self (250, 12, 64) and GQA
   (750, 4, 64) at t on both sides of every key-split boundary (Python int
   and device tensor); cross (300, 10, 64) and MQA cross (25, 120, 64) with
   a key mask holding one fully masked row (exactly 0), and in bf16 three
   more calls bitwise equal to the first;
5. K2/K3 ``flash_attention_fwd``/``_bwd`` in fp32 (3xTF32) and bf16, both
   on the tensor cores, at the training step's four shapes, one D = 128
   case and L = 2048 (``enc_max_seq_len`` as the joint encoder
   reaches it), ragged key masks (one batch entry fully masked at
   (384, 512, 64): zero output and gradients), a causal tail tile at
   L = 255; the VQ-VAEs' head width D = 48 at scale 384 ** -0.5, (8, 1024,
   48) unmasked (VQ training, one clip) and (32, 512, 48) with ragged
   lengths (four clips tokenized); causal plus the finetune's corruption key
   mask at (48, 255, 64); the speaker VQ's D = 96 at scale 768 ** -0.5,
   (8, 1024, 96) unmasked (its training clip) and (32, 512, 96) with ragged
   lengths and one batch entry fully masked. Tolerances: output fp32 2e-5, bf16 2e-2 (absolute and
   relative); gradients 1e-4 (fp32) and 2e-2 (bf16) of the reference's
   largest magnitude. One bf16 case runs K2 and K3 twice: o, lse, dq, dk, dv
   bitwise equal (no atomics, a fixed order of sums);
6. generation at full width (``slm_defaults()`` + ``vq_listener_defaults()``,
   random init from a seed, bf16): 25 synthetic clips of L=256, best-of-10
   through ``make_slmft_generator`` and ``evaluate_test_epoch`` with every
   launch count set to 0 just before and read just after (K1 2040, K4 2,
   K2/K3 0); then in fp32 at B0=4, N=2 one token sequence teacher-forced
   through ``decode_step`` with the kernels and with the plain versions
   (``plain_attention``; logits within 1e-3), and the VQ codes on the card
   against the CPU's;
7. times of generation and of K1/K4 (below), then grouped-query generation:
   the same with ``attn_kv_heads=1`` (one K/V head; cross attention folds
   G = 12 heads x N = 10 samples into NQ = 120 query rows), one generate
   call with the same launch counts, and one at N = 22 (NQ = 264, past
   K1's 256: each cross step runs K1 on two slices of 132 rows, so K1
   launches three times a layer and step), then the fp32 teacher-forced
   check at B0=2, N=10 and at B0=1, N=22;
8. training at full width: SLM, fp32 parameters under bf16 autocast, AdamW
   (1e-5, weight decay 0.01) with clip 1.0 and the VQ encoders and
   quantizers frozen, 32 synthetic CANDOR clips of L=256 (``bench.py:54``):
   3 warmup steps, then 10 steps, each between its own pair of CUDA events,
   with every launch count set to 0 just before and read just after (20
   K2, 20 K3 and 2 K4 a step), finite losses, frozen parameters bitwise
   unchanged and every trainable transformer parameter moved; then one fp32
   step at B=4 with ragged lengths (128-256) with the kernels and with the
   plain versions on the card (equal VQ codes, losses within 1e-5 relative,
   gradients of the non-VQ leaves within 1e-3 of each leaf's largest
   magnitude), and K4's codes in that step against the plain version on the
   latents it was given (``k4_on_path``; likewise in 10 and 11);
9. times after warmup: the median of 3 best-of-10 generate calls (host
   clock); for each kernel at the main paths' shapes (K2/K3 in bf16, and
   the D = 48 and 96 shapes in fp32 too), its plain version and
   one PyTorch library call on the same inputs where there is one
   (yardstick only, never on the port's path): ``ms``, the median of single
   launches each between its own pair of CUDA events (for K1 self, the
   median over sweeps t = 0..255 of a sweep's mean launch), which also
   times the host's path to the launch; ``graph_ms``, the same launches
   replayed from a CUDA graph between a pair of events, the card alone
   (K1 self, cross and MQA cross, K4, K2/K3, and SDPA beside K1-K3 as
   ``library_graph_ms``; in fp32 also the names of the kernels SDPA ran,
   from a trace); the training step's median, and three steps under
   ``torch.profiler`` tracing the card only (device busy share of that
   window, top device kernels);
10. VQ-VAE tokenizer training at full width (``vq_listener_defaults()``:
    hidden 384, 6 + 6 layers, 8 heads of 48, 512 x 128 codes), fp32, one
    synthetic clip of 1024 frames, AdamW (1e-4, weight decay 0.01): steps
    timed and traced as in 8 and 9, with 12 K2, 12 K3 and 1 K4 a step,
    finite metrics and every parameter moved; then one fp32 step with the kernels and with the
    plain versions (equal codes, metrics within 1e-5 relative, gradients
    within 1e-3 of each leaf's largest magnitude);
11. the SLMFT finetune at full width, fp32 parameters under bf16 autocast,
    4 synthetic ViCo clips of L = 256, AdamW (1e-5, weight decay 0.01), clip
    1.0, both VQs frozen: steps timed and traced as in 8 and 9, with 4 K2,
    4 K3 (the decoder's causal self-attention under the 15% corruption key
    mask) and 2 K4 a step, frozen VQs bitwise unchanged, every trainable
    transformer tensor moved; then one fp32 step at ragged lengths (128-256) against the
    plain versions, as in 10, on clips whose speaker moves
    (``_finetune_batch`` says why); and on the ViCo-shaped clips, the fp32
    runs with the kernels and with the plain versions against the plain
    versions in fp64: on each leaf the kernels' error within 1e-3 or 4x the
    plain fp32 run's;
12. the audio-visual speaker VQ-VAE's training at full width
    (``vq_speaker_defaults()``: hidden 768, 6 + 6 + 6 layers, 8 heads of 96,
    8 codes a frame), fp32, one synthetic clip of 1024 frames of listener
    motion || audio: steps timed and traced as in 10, with 18 K2, 18 K3 and
    1 K4 (8192 latents) a step; then one fp32 step with the kernels, one
    with the plain versions and one with the plain versions in fp64: codes
    equal and metrics within 1e-5 between the fp32 runs, gradients against
    fp64 as in 11 (``speaker_vq_train_reference`` says why);
13. the four CLI twins' ``main()`` on ViCo and CANDOR files written in the
    reference's layout (``real_files_path``): ``train_vq``, then
    ``train_s2s_pretrain`` with the token cache and prefetching from the
    VQ's checkpoint re-saved in the reference layout (K4 in epoch 1's steps,
    0 in epoch 2's), ``finetune_s2s_pretrain`` from the pretrain checkpoint
    and ``test_s2s_pretrain`` from the finetune checkpoint, with each
    twin's launch counts and each training twin's run record
    (``scalars.jsonl`` with the JAX CLIs' tags, ``hparams.json``);
14. the BIWI speaker family at full width (``slm_defaults()`` +
    ``vq_listener_defaults()``, 70110-d meshes, 15 speakers, fp32, seeded
    random weights, synthetic BIWI clips of 120 frames): SpeakerSLMFT
    best-of-50 generation of 4 clips, one a call, through
    ``make_speaker_generator`` and ``select_best_by_l2`` (a call: K1 952,
    K4 2, no K2/K3; ``speaker_generate_path``), its fp32 teacher-forced
    check at B0 = 1, N = 50, and K1 at the cross step's (12, 50, 64) over
    120 keys with a key mask against its plain version;
15. ``cli/test_biwi.main`` on its synthetic clips on the card (a clip: K2 4,
    K4 2), its files and LVE / FDD, and its predictions under
    ``plain_attention()`` (``test_biwi_twin``);
16. the SpeakerSLMFT finetune step (4 clips of 120, AdamW 1e-5, weight decay
    0.01, clip 1.0, ``SPEAKER_SLMFT_FROZEN``): steps timed and traced as in
    11 with 4 K2 and 4 K3 at (48, 119, 64) causal fp32 and 2 K4 a step, and
    its fp32 loss and gradients against the plain versions
    (``speaker_finetune_path``);
17. ``cli/train_converter.main`` (8 clips of 120, a mouth map, 2 epochs;
    K4 once a step), then its step timed and traced (``converter_path``);
18. K1 at the speaker path's fp32 shapes timed as in 9
    (``speaker_timings``);
19. the ListenerGenerator training step at full width
    (``listener_generator_defaults()``: dim 512, 6 + 6 layers, 8 heads of 64,
    512 codes; two ``vq_listener_defaults()`` VQs), fp32, 4 synthetic ViCo
    clips of L = 256 with ids, AdamW (1e-5, weight decay 0.01, no clip),
    ``LG_FROZEN``: steps timed and traced as in 11, with 12 K2, 12 K3 (6
    encoder layers at (32, 257, 64) with the key mask, 6 causal decoder
    layers at (32, 256, 64)) and 2 K4 a step; then one fp32 step at ragged
    lengths (128-256) against the plain versions, as in 11
    (``s2s_train_path``, ``s2s_train_reference``; the step's two fp32 shapes
    are in 5 and 9);
20. the ``test_s2s`` loop on that model, 4 clips of 256, 255 codes (K1
    3060, K2 6, K4 2 a batch), timed; its fp32 teacher-forced decode steps
    against the plain versions (logits within 1e-3); then
    ``cli.train_s2s.main`` (and ``--continuous``) and ``cli.test_s2s.main``
    (from a reference-layout ``.pt`` of the first) on ViCo files, the
    training runs' run records checked (``s2s_generate_path``);
21. ``StreamingListenerSession`` on SLMFT at full width, batch 4, chunk 8,
    max_frames 256: one feed, ``start`` (K4 once), 31 rounds of 8 frames
    and 8 codes (K1 8 a code), bf16, the round latency (host clock,
    synchronized) and codes/s; in fp32 the fed context rows against
    ``decoder_context`` (1e-4), teacher-forced ``stream_decode_step``
    logits against the plain versions (1e-3), and where greedy streaming
    first departs from offline ``generate_tokens`` (``streaming_path``);
22. ``StreamingSessionPool`` at capacity 8: staggered joins, a leave and a
    reused slot, bf16 rounds at full occupancy timed (codes/s), K1 n x 8
    launches a ``generate`` of n codes at 3 and 8 slots; in fp32 each slot's
    logits against a solo session's (1e-4) and their greedy agreement
    (``pool_path``);
23. ``StreamingSpeakerSession`` at the BIWI width, fp32: fed a whole clip,
    against ``make_speaker_generator`` greedy (the first divergence), its
    ``mesh`` against the offline decode of the same codes (1e-4)
    (``speaker_streaming_path``);
24. the wav2vec2-base trunk (7 conv layers of 512; 12 layers of 768, 12
    heads, FF 3072), seeded, fp32, over 4 BIWI-length waveforms of 77,200
    samples (241 conv frames, 120 motion frames after the trim): the card's
    features within 1e-4 of the CPU's on the same weights, and a clip's
    median ms (``speech_trunk_path``);
25. CodeTalker's training step at full width (``codetalker_defaults()``:
    feature_dim 1024, 6 decoder layers of 4 heads; the vertex VQ at
    70110-d; that trunk), fp32, B = 1, L = 120, Adam 1e-4 with
    ``CODETALKER_FROZEN``: 3 warmup steps, then 10 each between its own
    CUDA events with every launch count set to 0 just before it and read
    just after (K4 2, no K1/K2/K3), frozen tensors bitwise unchanged, every
    trainable one the loss reaches moved, 3 steps traced; then one loss
    from the trained weights with K4 and with its plain version (equal
    codes, losses within 1e-5 relative, gradients within 1e-3 of each
    leaf's largest magnitude, ``k4_on_path``) (``codetalker_train_path``);
26. ``CodeTalker.predict`` of one clip of 120 frames: K4 120, codes equal
    to the plain version's run, motion within 1e-4; the median of 3 calls,
    and K4 alone at (120, 128) (``codetalker_predict_path``);
27. ``cli.train_stage2`` (2 epochs, K4 8) and ``cli.test_biwi
    --data-root`` with the port's HuBERT extractor (a clip: K2 4, K4 2;
    twice, bitwise-equal predictions) on a ``write_biwi`` tree of 23,370
    vertices, 120 frames and 77,200 samples a clip; the extractor on the
    card against the CPU's within 1e-4 (``speech_files_path``);
28. ``StreamingAudioFrontend`` on the HuBERT-base trunk, batch 4, fps 30,
    chunk 8, window 60, lookahead 2, over 4 s pushed in irregular pieces:
    emissions bitwise equal to one whole push's; the median ms to emit a
    chunk (``audio_frontend_path``);
29. PIRender's ``FaceGenerator`` at full width (``RENDER_DEFAULTS``, 56-d
    EMOCA coefficients), seeded, a 256 x 256 source, a clip of 120 frames in
    windows of radius 13: ``render_clip`` in batches of 8, fp32 with TF32
    off (K1-K4: 0 launches), its first batch against the CPU's (flow, warp,
    fake within 1e-3 of each output's largest magnitude), the mixed config
    (bf16 mapping and editing nets, fp32 warp) against fp32 within
    ``RENDER_MIXED_BOUND``; a batch of 8 timed (median of 10 between CUDA
    events) in fp32, fp32 with TF32 and the mixed config, with peak memory
    and 3 batches traced (busy share, top kernels) (``render_path``);
30. ``cli.render_inference`` on a coefficient directory and with
    ``--video`` on a PNG VoxCeleb LMDB root, and ``cli.intuitive_control
    --synthetic``, at 256 x 256 through ``--checkpoint`` (a reference-layout
    ``.pt``): frame counts, frames against the same weights in memory within
    one uint8 level, K1-K4 at 0 (``render_files_path``);
31. the live avatar chain at ``bench.py``'s avatar shape: SLMFT at full
    width and ``FaceGenerator`` at 256 x 256, batch 1, chunk 8, 1024 frames
    and tokens, lookahead 8, radius 13, window 10, uint8 fake images, the
    download double-buffered; in fp32 ``FusedAvatarPipeline`` against
    ``StreamingAvatarPipeline`` over 24 chunks (codes bitwise, frames 5e-5,
    uint8 one level, the first rendered round), the live pipeline with
    ``vq_lookahead=None`` against the offline chain (one level); K2 at the
    masked decode's (8, 1024, 48) under a key mask against its plain version
    (bf16, 2e-2) and timed; fused rounds enqueued with no synchronizing
    call; each pipeline's push p50, frames/s, launches a round (K1 64, K2 6),
    peak memory and 3 traced rounds in the bench (bf16) and mixed (fp32
    warp) configs (``avatar_path``);
32. PIRender's training at full width (``RENDER_DEFAULTS``: 58-d
    coefficients into the 73-d ``pre`` conv, 256 x 256), VGG19 at a seeded
    random init, 4 scales, style 250 on the final loss: one warp step and one
    gen step (``pretrain_warp_iteration`` 1) on the card and on the CPU, fp32
    with TF32 off, at 1 pair, each step from the same weights: losses
    within ``RT_LOSS_TOL`` relative, each step's gradients within
    ``RT_GRAD_FACTOR`` times the distance the CPU's own move by when the
    weights move by ``RT_SENSITIVITY_EPS`` of themselves (in the largest
    error and in relative L2), and the share of elements whose updates
    differ (a near-zero gradient's sign: 2 lr) within ``RT_GRAD_FACTOR``
    times the CPU's own; the control, the gen step with TF32 on, must fail
    both (``_rt_check``); then each stage at
    ``RT_PAIRS`` pairs (8 images after the symmetric concat, the port's
    choice: ``render_path``'s batch) timed in fp32 with TF32 off and on
    (median of 10 steps between CUDA events after 3 warmups, images/s, peak
    memory, 3 steps traced), K1-K4 at 0 a step; ``cli.render_train
    --synthetic --resolution 256 --debug 3`` and ``cli.render_inference``
    reading the checkpoint it wrote (``render_train_path``);
33. ``cli.train_vq --synthetic --mesh data=1`` on the card (NCCL, a group
    of one) against the same run without ``--mesh``: the best validation
    loss within 1e-5 relative and the same K1-K4 launch counts;
    ``MeshPlan.parse("data=2")`` on one card raises the device-count error
    (``mesh_path``);
34. the VQ attention at D = 48 and 96 by both routes (``attend`` and
    K2/K3), forward and backward, graph-timed at L = 256, 512, 768 and 1024
    in fp32 and bf16; then the ``kernels`` JSON line and, last, the device
    JSON line.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on tensor cores, 67 TFLOP/s fp32 on CUDA cores (K4), and for fp32
K2/K3, whose products are three TF32 ones each, 495 / 3 = 165 TFLOP/s.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32 K2/K3 run in 3xTF32: three TF32 operations on the tensor cores
# (495 TFLOP/s) for each fp32 one
FP32_ATTN_OPS = 495e12 / 3
B0, N, L = 25, 10, 256
FAILURES = []
CARD = []  # the card's name and power limit, as nvidia-smi prints them


def say(*parts):
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    say(("ok   " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def phase(fn):
    def run(*args, **kwargs):
        say(f"== {fn.__name__}")
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        except Exception:  # report the phase as failed, keep the others going
            traceback.print_exc(file=sys.stdout)
            FAILURES.append(f"{fn.__name__} raised")
            return None
        finally:
            say(f"   {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return run


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn(i)`` over ``reps`` calls, each between its own pair
    of CUDA events, after 3 warmups."""
    for i in range(3):
        fn(i)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for i, (start, end) in enumerate(pairs):
        start.record()
        fn(i)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def graph_ms(fn, stream=None, reps: int = 7, inner: int = 10) -> float:
    """Median ms of one ``fn()`` on the card alone: ``inner`` calls are
    captured into a CUDA graph and each of ``reps`` replays is timed between
    its own pair of CUDA events, so the host's launch path, which can cost
    more than a short kernel, is not in the number. ``stream`` is the capture
    stream: autograd runs a backward on its forward's stream, so a captured
    backward needs its forward made on that stream."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            fn()
    graph.replay()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / inner


def _autograd_pair(f, inputs, grad_out):
    """``f`` on leaves of its own made on the current stream, as (forward,
    backward) closures: autograd runs a backward on its forward's stream, so
    a backward captured in a graph needs its forward made on that stream."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = f(*leaves)
    return (lambda: f(*leaves),
            lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True))


def bound_ms(nbytes: float, ops: float, dtype, ops_per_s=None) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or PEAK_OPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_attention():
    """Inside, the x-transformers stack and the VQ-VAEs' attention call the
    plain versions of K1 (``decode_attention``) and K2/K3
    (``flash_attention``) on the card, so a path can be held against itself
    without the kernels."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention_plain
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention_plain
    from dyadic_interaction_modeling_tpu_torch.models import xtrans
    from dyadic_interaction_modeling_tpu_torch.ops import transformer

    with mock.patch.multiple(xtrans, decode_attention=decode_attention_plain,
                             flash_attention=flash_attention_plain), \
            mock.patch.object(transformer, "flash_attention", flash_attention_plain):
        yield


@contextlib.contextmanager
def k4_calls(plain=False):
    """Inside, every K4 launch of the model (``ops.quantizer``'s) is recorded
    as (latents, codebook, codes), so that the codes a path took can be held
    against the plain version on the same latents afterwards; with
    ``plain``, the plain version runs in K4's place on the card."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code_plain
    from dyadic_interaction_modeling_tpu_torch.ops import quantizer

    calls, kernel = [], nearest_code_plain if plain else quantizer._nearest_code

    def record(z, e):
        idx = kernel(z, e)
        calls.append((z.detach().clone(), e.detach().clone(), idx))
        return idx

    with mock.patch.object(quantizer, "_nearest_code", record):
        yield calls


def k4_on_path(calls, what):
    """Recorded K4 codes against ``nearest_code_plain`` on the same latents:
    equal, but for rows whose two codes' fp64 distances tie to 1e-5 of
    |z|^2 + |e|^2 (the rounding of two fp32 sums in different orders), and
    at most 0.1% of the rows (the random-input rule of ``k4_check``)."""
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code_plain

    rows = differ = 0
    worst = 0.0
    for z, e, got in calls:
        ref = nearest_code_plain(z, e)
        diff = got != ref
        scale = (z.double() ** 2).sum(1) + (e.double()[ref.long()] ** 2).sum(1)
        gap = (_dist64(z, e, got) - _dist64(z, e, ref)).abs() / scale
        worst = max(worst, float(gap[diff].max()) if bool(diff.any()) else 0.0)
        rows, differ = rows + got.numel(), differ + int(diff.sum())
    shapes = sorted({(tuple(z.shape), tuple(e.shape)) for z, e, _ in calls})
    if len(shapes) > 4:  # a growing prefix: the first and the last
        shapes = f"{len(shapes)} shapes, {shapes[0]} to {shapes[-1]}"
    check(bool(calls) and worst <= 1e-5 and differ <= rows // 1000,
          f"K4 on {what}'s own latents ({len(calls)} launches at {shapes}): "
          f"{rows - differ} of {rows} codes equal to the plain version's, the others "
          f"ties (largest relative distance gap {worst:.3g}, tol 1e-5)")
    return {"launches": len(calls), "rows": rows, "differ": differ, "tie_gap": worst}


@phase
def device():
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    say(line)
    CARD.append(line)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return line


@phase
def build():
    """The extension, and beside it ``nvcc -Xptxas -v`` of the fp32 attention
    source alone: registers and spills of every instantiation."""
    from concurrent.futures import ThreadPoolExecutor

    from dyadic_interaction_modeling_tpu_torch.cli.flash_mma_resources import resources
    from dyadic_interaction_modeling_tpu_torch.kernels import build as B

    with ThreadPoolExecutor(1) as pool:
        ptxas = pool.submit(resources, "flash_attention.cu")
        t0 = time.perf_counter()
        B.extension()
        secs = time.perf_counter() - t0
        _, code, output, lines = ptxas.result()
    say(f"built {', '.join(B.SOURCES)} with torch.utils.cpp_extension.load in "
        f"{secs:.1f} s (nvcc {' '.join(B.CUDA_FLAGS)})")
    check(code == 0, f"nvcc -Xptxas -v flash_attention.cu exits {code}"
          + ("" if code == 0 else f": {output[-2000:]}"))
    kernels = {}
    for name, line in lines:
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_bytes", r"(\d+) bytes spill stores")):
            found = re.search(pat, line)
            if found:
                kernels.setdefault(name, {})[key] = int(found.group(1))
    sha = hashlib.sha1((B.CSRC / "flash_attention.cu").read_bytes()).hexdigest()[:12]
    say(f"ptxas flash_attention.cu (fp32 K2/K3, 3xTF32; sha1 {sha}): " + "; ".join(
        f"{name} {r.get('registers')} regs {r.get('spill_bytes')} B spilled"
        for name, r in kernels.items()))
    return secs, kernels


def _dist64(z, e, idx):
    z, e = z.double(), e.double()
    return ((z - e[idx.long()]) ** 2).sum(1)


@phase
def k4_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    e = torch.randn(512, 128, device="cuda", generator=g)
    want = torch.randint(0, 512, (6400,), device="cuda", generator=g)
    z = e[want] + 0.01 * torch.randn(6400, 128, device="cuda", generator=g)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    check(bool((got == want.int()).all()) and bool((nearest_code_plain(z, e) == got).all()),
          "K4 margin inputs: exact indices (kernel == plain == truth)")
    z = torch.randn(6400, 128, device="cuda", generator=g)
    e = torch.randn(512, 128, device="cuda", generator=g)
    got, ref = nearest_code(z, e), nearest_code_plain(z, e)
    agree = float((got == ref).float().mean())
    gap = float((_dist64(z, e, got) - _dist64(z, e, ref)).abs().max())
    check(agree >= 0.999, f"K4 random inputs: {agree:.5f} of rows agree (>= 0.999), "
          f"max distance gap {gap:.3g}")
    zn = z[:64].clone()
    zn[5] = float("nan")
    got = nearest_code(zn, e)
    check(bool((got == nearest_code_plain(zn, e)).all()) and int(got[5]) == 0,
          "K4 NaN latent: code 0, other rows as the plain version")
    # the SLM training step's shape, the VQ training and finetune steps' (one
    # clip of 1024 frames; 4 clips of 256), and ragged N and n_e against the
    # kernel's tiles
    for n, n_e, d in ((8192, 512, 128), (1024, 512, 128), (6401, 500, 128), (70, 130, 20)):
        e = torch.randn(n_e, d, device="cuda", generator=g)
        want = torch.randint(0, n_e, (n,), device="cuda", generator=g)
        z = e[want] + 0.01 * torch.randn(n, d, device="cuda", generator=g)
        got = nearest_code(z, e)
        exact = bool((got == want.int()).all()) and bool((nearest_code_plain(z, e) == got).all())
        z = torch.randn(n, d, device="cuda", generator=g)
        a = float((nearest_code(z, e) == nearest_code_plain(z, e)).float().mean())
        check(exact and a >= 0.999, f"K4 ({n}, {d}) x ({n_e}, {d}): exact on margin "
              f"inputs {exact}, {a:.5f} of random rows agree (>= 0.999)")
        agree = min(agree, a)
    return {"max_abs_err": gap, "agree": agree}


def _k1_inputs(rows, nq, dtype, g, masked=False, n_sets=1, group=12):
    """q, k, v at L and, with ``masked``, a (rows // group, L) key mask whose
    row 3 is fully masked (cache rows [3 group, 4 group))."""
    sets = []
    for _ in range(n_sets):
        q = torch.randn(rows, nq, 64, device="cuda", generator=g).to(dtype)
        k = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        v = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        mask = None
        if masked:
            mask = torch.rand(rows // group, L, device="cuda", generator=g) < 0.8
            mask[:, 0] = True
            mask[3] = False  # one fully masked context row
        sets.append((q, k, v, mask))
    return sets


# t on both sides of the key splits' boundaries (chunks of 16, 32 or 64 keys)
SPLIT_TS = (0, 1, 15, 16, 31, 32, 63, 64, 127, 128, 191, 192, 200, 255)


@phase
def k1_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}

    def err(out, ref):
        return float((out.float() - ref.float()).abs().max())

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        errs = []
        # (name, rows, NQ): self, MQA self (G = 12), GQA (G = 4), under t bounds
        for name, rows, nq in (("self", 3000, 1), ("MQA self", 250, 12), ("GQA", 750, 4)):
            (q, k, v, _), = _k1_inputs(rows, nq, dtype, g)
            e = 0.0
            for t in SPLIT_TS:
                ref = decode_attention_plain(q, k, v, t, scale=0.125)
                for tt in (t, torch.tensor(t, dtype=torch.int32, device="cuda")):
                    e = max(e, err(decode_attention(q, k, v, tt, scale=0.125), ref))
            check(e <= tol, f"K1 {name} {tag} ({rows},{nq},64) L=256, t in {SPLIT_TS} as "
                  f"int and device tensor: max abs err {e:.3g} (tol {tol})")
            errs.append(e)
        # cross attention with a key mask holding one fully masked context row:
        # best-of-10 (300, 10) and MQA best-of-10 (25, 120)
        for name, rows, nq, group in (("cross", 300, 10, 12), ("MQA cross", 25, 120, 1)):
            (q, k, v, mask), = _k1_inputs(rows, nq, dtype, g, masked=True, group=group)
            out = decode_attention(q, k, v, None, mask, scale=0.125)
            e = err(out, decode_attention_plain(q, k, v, None, mask, scale=0.125))
            zero = float(out[3 * group:4 * group].float().abs().max())
            same = True
            if dtype == torch.bfloat16:
                same = all(torch.equal(out, decode_attention(q, k, v, None, mask, scale=0.125))
                           for _ in range(3))
            check(e <= tol and zero == 0.0 and same,
                  f"K1 {name} {tag} ({rows},{nq},64) masked, one fully masked row: max abs "
                  f"err {e:.3g} (tol {tol}), masked row max {zero}"
                  + (f", three more calls bitwise equal: {same}" if dtype == torch.bfloat16
                     else ""))
            errs.append(e)
        worst[tag] = max(errs)
    torch.cuda.synchronize()
    return worst


HEADS = 12
VQ_SCALE = 384 ** -0.5  # the VQ-VAEs' full-width scale (reference quirk), D = 384 / 8
SPK_SCALE = 768 ** -0.5  # the speaker VQ's, D = 768 / 8
# (name, rows, L, D, heads, key mask, causal, scale, launches per SLM training
# step); rows are batch x heads, a key mask (rows / heads, L): "prefix"
# ragged lengths from L/2 to L, "random" the finetune's corruption (15% of
# the keys a row, never key 0)
K23_CASES = (
    ("encoder_s/l (384,256,64) masked", 384, 256, 64, HEADS, "prefix", False, 0.125, 8),
    ("encoder_joint 2L (384,512,64) masked", 384, 512, 64, HEADS, "prefix", False, 0.125, 4),
    ("marginal joint (768,256,64) masked", 768, 256, 64, HEADS, "prefix", False, 0.125, 4),
    ("decoder self (768,255,64) causal", 768, 255, 64, HEADS, None, True, 0.125, 4),
    ("D=128 (192,512,128) masked", 192, 512, 128, HEADS, "prefix", False, 128 ** -0.5, 0),
    ("enc_max_seq_len (24,2048,64) masked", 24, 2048, 64, HEADS, "prefix", False, 0.125, 0),
    ("VQ train (8,1024,48)", 8, 1024, 48, 8, None, False, VQ_SCALE, 0),
    ("VQ tokenize B=4 (32,512,48) masked", 32, 512, 48, 8, "prefix", False, VQ_SCALE, 0),
    ("finetune decoder (48,255,64) causal+mask", 48, 255, 64, HEADS, "random", True, 0.125,
     0),
    ("speaker decoder (48,119,64) causal", 48, 119, 64, HEADS, None, True, 0.125, 0),
    ("s2s encoder (32,257,64) masked", 32, 257, 64, 8, "prefix", False, 0.125, 0),
    ("s2s decoder (32,256,64) causal", 32, 256, 64, 8, None, True, 0.125, 0),
    ("speaker VQ train (8,1024,96)", 8, 1024, 96, 8, None, False, SPK_SCALE, 0),
    ("speaker VQ B=4 (32,512,96) masked", 32, 512, 96, 8, "prefix", False, SPK_SCALE, 0),
)
DEAD_CASE = 1  # index of the case with one fully masked batch entry, run twice in bf16
# the cases with one fully masked batch entry (zero output and gradients)
DEAD_CASES = (DEAD_CASE, len(K23_CASES) - 1)
# the cases also timed in fp32: the VQ-VAEs' (D = 48 and 96; VQ training's
# dtype), SpeakerSLMFT's teacher-forced decoder (fp32 in test_biwi and its
# finetune step) and the ListenerGenerator step's two (fp32, the JAX CLI's)
FP32_CASES = tuple(i for i, c in enumerate(K23_CASES)
                   if c[3] in (48, 96) or c[0].startswith(("speaker decoder", "s2s ")))
SOURCES = {torch.float32: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention.cu",
           torch.bfloat16: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention_mma.cu"}


def _attn_inputs(rows, l, d, heads, dtype, g, mask_kind, dead=False):
    q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    mask = None
    if mask_kind == "prefix":
        lens = torch.randint(l // 2, l + 1, (rows // heads,), device="cuda", generator=g)
        mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
    elif mask_kind == "random":  # the finetune's input corruption
        from dyadic_interaction_modeling_tpu_torch.models.xtrans import ar_mask_prob_kv_mask

        mask = ar_mask_prob_kv_mask(rows // heads, l, 0.15, generator=g, device="cuda")
    if dead:
        mask[1] = False
    return q, k, v, do, mask


@phase
def k23_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for dtype, tol_o, tol_g in ((torch.float32, 2e-5, 1e-4), (torch.bfloat16, 2e-2, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        e_o, e_g, e_ga = [], [], []
        for i, (name, rows, l, d, heads, mask_kind, causal, scale, _) in enumerate(K23_CASES):
            q, k, v, do, mask = _attn_inputs(rows, l, d, heads, dtype, g, mask_kind,
                                             i in DEAD_CASES)
            kw = dict(causal=causal, scale=scale)
            o, lse = flash_attention_fwd(q, k, v, mask, **kw)
            ro, rlse = flash_attention_fwd_plain(q, k, v, mask, **kw)
            grads = flash_attention_bwd(q, k, v, ro, do, rlse, mask, **kw)
            refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, **kw)
            torch.cuda.synchronize()
            diff = (o.float() - ro.float()).abs()
            rtol = 0.0 if dtype == torch.float32 else tol_o
            ok_o = bool((diff <= tol_o + rtol * ro.float().abs()).all())
            fin = torch.isfinite(rlse)
            same_inf = torch.equal(fin, torch.isfinite(lse))
            err_lse = float((lse[fin] - rlse[fin]).abs().max())
            err_g = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                     for a, b in zip(grads, refs)]
            err_ga = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(grads, refs))
            zero = True
            if i in DEAD_CASES:
                dead = slice(heads, 2 * heads)
                zero = (float(o[dead].float().abs().max()) == 0.0 and all(
                    float(x[dead].float().abs().max()) == 0.0 for x in grads)
                    and bool(torch.isinf(lse[dead]).all()))
            check(ok_o and same_inf and err_lse <= 1e-4 and max(err_g) <= tol_g and zero,
                  f"K2/K3 {tag} {name}: o max abs err {float(diff.max()):.3g} "
                  f"(tol {tol_o}{' + rel' if rtol else ''}), lse {err_lse:.3g}, dq/dk/dv "
                  f"rel {err_g[0]:.3g}/{err_g[1]:.3g}/{err_g[2]:.3g} (tol {tol_g})"
                  + (f", fully masked entry zero: {zero}" if i in DEAD_CASES else ""))
            e_o.append(float(diff.max()))
            e_g.append(max(err_g))
            e_ga.append(err_ga)
            if i == DEAD_CASE and dtype == torch.bfloat16:
                again = (*flash_attention_fwd(q, k, v, mask, **kw),
                         *flash_attention_bwd(q, k, v, ro, do, rlse, mask, **kw))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip((o, lse, *grads), again)),
                      f"K2/K3 {tag} {name}: a second call gives bitwise the same o, lse, "
                      "dq, dk, dv")
        worst[tag] = {"fwd_abs": max(e_o), "bwd_rel": max(e_g), "bwd_abs": max(e_ga)}
    return worst


def _model(dtype, seed=0, kv_heads=0):
    """SLMFT at full width; ``kv_heads`` = 1 is grouped-query (MQA) attention."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    slm_cfg, vq_cfg = slm_defaults(), vq_listener_defaults()
    slm_cfg["attn_kv_heads"] = kv_heads
    torch.manual_seed(seed)
    model = SLMFT(slm_cfg, vq_cfg)
    return model, slm_cfg


def _clips(n_clips, seed=3):
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    ds = synthetic_vico_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    return [slm_batch_from_collated(c) + (c[5],)
            for c in PaddedBatchLoader(ds, n_clips, shuffle=False)]


def _generate(kv_heads, n=N):
    """Best-of-n generation of B0 clips, every launch count set to 0 just
    before and read just after. K1 takes a cross step's G n query rows a
    context whole while they fit it (``MAX_NQ``), else in equal slices."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        evaluate_test_epoch, make_slmft_generator)
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import MAX_NQ
    from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics

    model, slm_cfg = _model(torch.bfloat16, kv_heads=kv_heads)
    model = model.to("cuda", torch.bfloat16).eval()
    gen = make_slmft_generator(model)
    batches = _clips(B0)
    seen = {}

    def traced(batch, g, n):
        cands, tokens = gen(batch, g, n, return_tokens=True)
        seen["cands"], seen["tokens"] = cands, tokens
        return cands

    rng = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_launch_counts()
    y_true, y_pred, xs, _ = evaluate_test_epoch(model, traced, batches, rng,
                                                beam_size=n, device="cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tag = f"MQA (attn_kv_heads=1) best-of-{n} " if kv_heads else f"best-of-{n} "
    say(f"launches in the {tag}run: {launches}")
    cands, tokens = seen["cands"], seen["tokens"]
    check(tuple(cands.shape) == (B0, n, L - 1, 56),
          f"{tag}candidate shape {tuple(cands.shape)} == {(B0, n, L - 1, 56)}")
    check(bool(torch.isfinite(cands.float()).all()), f"{tag}candidates finite")
    check(bool(((tokens >= 0) & (tokens < 512)).all()), f"{tag}tokens in [0, 512)")
    cross_nq = (slm_cfg["dec_heads"] // (kv_heads or slm_cfg["dec_heads"])) * n
    slices = -(-cross_nq // MAX_NQ)
    want = {"decode_attention": (L - 1) * 4 * (1 + slices), "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "nearest_code": 2}
    check(launches == want, f"{tag}generation launches {launches} == {want} (K1 "
          f"on the self step and {slices} slice(s) of the cross step's {cross_nq} rows "
          "in 4 decoder layers x 255 steps, K4 twice, no K2/K3)")
    m = print_metrics(y_true, y_pred, xs, verbose=False)
    fd = [m[k] for k in ("fid_pose", "fid_exp", "mse_pose", "mse_exp")]
    check(all(v == v and abs(v) != float("inf") for v in fd),
          f"{tag}FD and MSE finite: fid_pose {m['fid_pose']:.4f} fid_exp {m['fid_exp']:.4f}")
    return model, gen, batches[0], launches


@phase
def slice_main_path():
    return _generate(kv_heads=0)


MQA_WIDE_N = 22  # G N = 264 query rows a context: past K1's 256, two slices


@phase
def mqa_main_path():
    """Grouped-query generation (one K/V head: step_cross folds G = 12 heads
    x N = 10 samples into NQ = 120 query rows a context), one generate call;
    then one at N = MQA_WIDE_N, whose cross steps K1 takes in two slices."""
    launches = _generate(kv_heads=1)[3]
    torch.cuda.empty_cache()
    wide = _generate(kv_heads=1, n=MQA_WIDE_N)[3]
    torch.cuda.empty_cache()
    return launches, wide


def _reference(b0, n, kv_heads):
    """fp32 at B0 clips x N samples: kernels vs plain versions on the card,
    and the card's VQ codes against the CPU's."""
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    tag = f"{'MQA ' if kv_heads else ''}B0={b0} N={n}"
    cpu_model, _ = _model(torch.float32, seed=1, kv_heads=kv_heads)
    cpu_model.eval()
    model = _model(torch.float32, seed=1, kv_heads=kv_heads)[0].to("cuda").eval()
    batch = _clips(b0, seed=5)[0]
    src_v, tgt, src_a, mask = (torch.as_tensor(x) for x in batch[:4])
    with torch.no_grad():
        codes_cpu = cpu_model.forward_vq(src_v, tgt, mask)[1]
        codes_gpu = model.forward_vq(src_v.cuda(), tgt.cuda(), mask.cuda())[1].cpu()
        same = float((codes_cpu == codes_gpu).float().mean())
        check(same >= 0.99, f"{tag} listener VQ codes, card (K4) vs CPU (plain): "
              f"{same:.4f} equal (>= 0.99)")
        ctx, prompt = model.encode_context(src_v.cuda(), tgt.cuda(), src_a.cuda(),
                                           mask.cuda())
        dec = model.decoder
        cross = dec.cross_kv(ctx)
        g = torch.Generator(device="cuda").manual_seed(4)
        seq = torch.randint(0, 512, (n * b0, L - 1), device="cuda", generator=g)
        seq = torch.cat([prompt.repeat(n, 1).to(seq.dtype), seq], dim=1)
        maskc = mask.cuda()
        worst = 0.0
        caches = [init_decoder_cache(n * b0, L, dec.depth, dec.heads, dec.dim_head,
                                     torch.float32, dec.kv_heads, "cuda")
                  for _ in range(2)]
        for t in range(L):
            tok = seq[:, t: t + 1]
            a = dec.decode_step(tok, caches[0], t, cross, maskc, n)
            with plain_attention():
                b = dec.decode_step(tok, caches[1], t, cross, maskc, n)
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"teacher-forced decode_step fp32 {tag}, {L} steps: "
          f"logits max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    return worst


@phase
def slice_reference():
    return _reference(4, 2, kv_heads=0)


@phase
def mqa_reference():
    """Cross attention at NQ = G x N = 120 query rows a context."""
    return _reference(2, N, kv_heads=1)


@phase
def mqa_wide_reference():
    """Cross attention at NQ = G x N = 264 query rows a context, past
    ``MAX_NQ``: K1 on two slices against the plain step."""
    return _reference(1, MQA_WIDE_N, kv_heads=1)


TRAIN_B, TRAIN_STEPS, WARMUP_STEPS, PROFILED_STEPS = 32, 10, 3, 3
STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 20,
                 "flash_attention_bwd": 20, "nearest_code": 2}


def _slm(seed):
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM

    torch.manual_seed(seed)
    return SLM(slm_defaults(), vq_listener_defaults())


def _candor(n_clips, seed):
    """n_clips synthetic CANDOR clips of length L, as one batch on the card."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_candor_dataset

    ds = synthetic_candor_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    collated = next(iter(PaddedBatchLoader(ds, n_clips, shuffle=False)))
    return tuple(torch.as_tensor(x, device="cuda") for x in slm_batch_from_collated(collated))


@phase
def train_main_path():
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM_FROZEN

    model = _slm(seed=0).to("cuda")
    opt = make_optimizer(model, 1e-5, 0.01, SLM_FROZEN)
    step = make_slm_train_step(model, opt, 1.0, torch.bfloat16)
    batch = _candor(TRAIN_B, seed=7)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(0)
    logs = [step(batch, g) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    kernels.reset_launch_counts()
    for start, end in pairs:
        start.record()
        logs.append(step(batch, g))
        end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    times = [start.elapsed_time(end) / 1e3 for start, end in pairs]
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    say(f"launches in {TRAIN_STEPS} training steps: {launches}")
    check(launches == want, f"training launches == {want} (20 K2, 20 K3, 2 K4 a step)")
    check(all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values()),
          f"losses finite over {len(logs)} steps")
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(torch.equal(model.get_parameter(k), before[k])
                               for k in frozen),
          f"{len(frozen)} frozen VQ encoder/quantizer tensors bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith(("encoder_", "decoder_joint"))]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable transformer tensors moved "
          f"(unmoved: {still[:5]})")
    med = statistics.median(times)
    first = {k: round(float(v), 4) for k, v in logs[0].items()}
    last = {k: round(float(v), 4) for k, v in logs[-1].items()}
    say(f"SLM train step B={TRAIN_B} L={L} bf16 autocast, CUDA events: median "
        f"{med * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in times]} -> {TRAIN_B * L / med:.0f} frames/s")
    say(f"logs of the first warmup step {first}; of the last step {last}")
    return {"model": model, "step": step, "batch": batch, "gen": g,
            "launches": launches, "step_ms": med * 1e3,
            "step_runs_ms": [t * 1e3 for t in times]}


@phase
def train_reference():
    """One fp32 step at B=4 with ragged lengths: kernels against the plain
    versions on the card, from the same weights and noise; K4's codes
    against the plain version on the latents it was given."""
    what = "the SLM training step"
    b = 4
    src_v, tgt, src_a, _ = _candor(b, seed=9)
    lens = torch.tensor([L, 211, 170, 128], device="cuda")
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    state = _slm(seed=1).state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = tuple(torch.rand(b, L, device="cuda", generator=g) for _ in range(2))
    results, codes = [], []
    for plain in (False, True):
        model = _slm(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            with torch.no_grad():
                codes.append(model.forward_vq(src_v, tgt, mask))
            out = model(src_v, tgt, src_a, mask, noise=noise)
            out.total_loss.backward()
        logs = {k: float(v) for k, v in out.logs.items()}
        logs["total"] = float(out.total_loss.detach())
        results.append((logs, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, what)
    check(all(torch.equal(a, b) for a, b in zip(*codes)),
          "both runs' speaker and listener VQ codes equal (K4 is deterministic)")
    (lk, gk), (lp, gp) = results
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, "fp32 step B=4 ragged, kernels vs plain: losses "
          f"rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gp}
    core = {k: e for k, e in errs.items() if "_vq." not in k}
    vq = {k: e for k, e in errs.items() if "_vq." in k}
    worst = max(core, key=core.get)
    check(core[worst] <= 1e-3, f"gradients of {len(core)} non-VQ leaves within 1e-3 of "
          f"each leaf's max: worst {core[worst]:.3g} ({worst})")
    say(f"VQ-decoder leaves (float-noise gradients, reported only): worst "
        f"{max(vq.values()):.3g} over {len(vq)} leaves")
    return {"loss_rel": max(rel.values()), "grad_rel": core[worst], "k4": k4}


def _attn_bound(rows, l, d, dtype, mask, causal, bwd):
    """Bytes each input is read and each output written once, of K and V
    only the rows the key mask keeps (no query needs the others); operations
    of the (query, key) pairs this data attends: 4 D per pair forward (Q Kᵀ,
    P V), 10 D backward (Q Kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ Q), at the bf16 rate,
    or in fp32 at the 3xTF32 one (``FP32_ATTN_OPS``)."""
    es = torch.finfo(dtype).bits // 8
    if mask is not None:  # key j is attended by l - j queries under causal, else l
        w = l - torch.arange(l, device=mask.device) if causal else l
        pairs = (rows // mask.shape[0]) * float((mask.long() * w).sum())
    elif causal:
        pairs = rows * l * (l + 1) / 2
    else:
        pairs = rows * l * l
    extra = rows * l * 4 + (0 if mask is None else mask.numel())
    io = rows * l * d * es  # one (rows, L, D) tensor
    kv = io if mask is None else (rows // mask.shape[0]) * float(mask.sum()) * d * es
    rate = FP32_ATTN_OPS if dtype == torch.float32 else None
    if bwd:  # q, o, dO, dq, dk, dv whole; k, v as kept
        return bound_ms(6 * io + 2 * kv + extra, 10 * d * pairs, dtype, rate)
    return bound_ms(2 * io + 2 * kv + extra, 4 * d * pairs, dtype, rate)


def _trace_steps(step, args, what):
    """The same window of PROFILED_STEPS steps traced twice by
    ``torch.profiler``: the card alone (its busy share is the one reported),
    then also the host's operators. Returns the two windows and the device
    kernels with the most time a step (name, µs, launches), from the
    second."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from dyadic_interaction_modeling_tpu_torch.cli.profile_generate import _busy_us

    windows = {}
    for tag, acts in (("card", [ProfilerActivity.CUDA]),
                      ("card+host", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(*args)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = _busy_us(kern)
        windows[tag] = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                        "busy_share": busy / wall_us, "kernels": len(kern)}
        say(f"{PROFILED_STEPS} {what} steps traced ({tag}): wall {wall_us / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
            f"{len(kern)} kernels")
    check(windows["card"]["kernels"] > 0, f"tracing the card alone records the {what} "
          "step's kernels")
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, cnt + 1)
    top = [(name, tot / PROFILED_STEPS, cnt / PROFILED_STEPS) for name, (tot, cnt)
           in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    say(f"device time a {what} step by kernel (card+host window):")
    for name, tot, cnt in top:
        say(f"  {tot / 1e3:9.3f} ms  {cnt:7.1f} x  {name[:100]}")
    return windows, top


def _kernel_names(fn):
    """The names of the device kernels that a call of ``fn`` runs (three
    calls are traced: a window of one call has come back without its device
    events)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})


@phase
def train_timings(train):
    import torch.nn.functional as F
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    windows, top = _trace_steps(train["step"], (train["batch"], train["gen"]), "train")
    del train["model"], train["step"]
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    cases = {}
    # every case in bf16, the FP32_CASES also in fp32
    runs = [(c, bf, c[0]) for c in K23_CASES]
    runs += [(K23_CASES[i], torch.float32, K23_CASES[i][0] + " fp32") for i in FP32_CASES]
    for (name, rows, l, d, heads, mask_kind, causal, scale, per_step), dt, key in runs:
        q, k, v, do, mask = _attn_inputs(rows, l, d, heads, dt, g, mask_kind)
        kw = dict(causal=causal, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, mask, **kw)
        b = rows // heads
        m4 = None if mask is None else mask[:, None, None, :]
        if causal and m4 is not None:  # SDPA takes a mask or is_causal, not both
            m4 = m4 & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()

        def sdpa_fwd(q4, k4, v4, m4=m4, causal=causal and m4 is None, scale=scale):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, is_causal=causal,
                                                  scale=scale)

        as4 = [x.view(b, heads, l, d) for x in (q, k, v)]
        sdpa, sdpa_bwd = _autograd_pair(sdpa_fwd, as4, do.view(b, heads, l, d))
        side = torch.cuda.Stream()  # a second forward, for the captured backward
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, sdpa_bwd_side = _autograd_pair(sdpa_fwd, as4, do.view(b, heads, l, d))
        torch.cuda.current_stream().wait_stream(side)
        # ms and library_ms: single launches between events, the method of every
        # other kernel here; graph_ms and library_graph_ms: the card alone
        fwd = dict(
            ms=cuda_ms(lambda i: flash_attention_fwd(q, k, v, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(q, k, v, mask, **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa(), 20),
            graph_ms=graph_ms(lambda: flash_attention_fwd(q, k, v, mask, **kw)),
            library_graph_ms=graph_ms(sdpa))
        fwd["bound_ms"], fwd["bound_by"] = _attn_bound(rows, l, d, dt, mask, causal, False)
        bwd = dict(
            ms=cuda_ms(lambda i: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_bwd_plain(q, k, v, o, do, lse, mask,
                                                                 **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa_bwd(), 20),
            graph_ms=graph_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw)),
            library_graph_ms=graph_ms(sdpa_bwd_side, stream=side))
        bwd["bound_ms"], bwd["bound_by"] = _attn_bound(rows, l, d, dt, mask, causal, True)
        cases[key] = {"per_step": per_step if dt == bf else 0, "dtype": str(dt)[6:],
                      "fwd": fwd, "bwd": bwd}
        if dt == torch.float32:  # which of PyTorch's fp32 attention kernels SDPA ran
            cases[key]["sdpa_kernels"] = [n for n in _kernel_names(lambda: (sdpa(), sdpa_bwd()))
                                          if "fmha" in n or "ttention" in n]
            say(f"SDPA {key}: {[n[:70] for n in cases[key]['sdpa_kernels']]}")
        for tag, r in (("K2", fwd), ("K3", bwd)):
            say(f"{tag} {key}{'' if dt != bf else ' bf16'}: kernel {r['ms'] * 1e3:.1f} us, "
                f"plain {r['plain_ms'] * 1e3:.1f} us, SDPA {r['library_ms'] * 1e3:.1f} us, "
                f"from a CUDA graph: kernel {r['graph_ms'] * 1e3:.1f} us, SDPA "
                f"{r['library_graph_ms'] * 1e3:.1f} us, "
                f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        del q, k, v, do, o, lse, sdpa, sdpa_bwd, sdpa_bwd_side
        torch.cuda.empty_cache()
    per_step = {}
    for which in ("fwd", "bwd"):
        per_step[which] = {key: sum(c["per_step"] * c[which][key] for c in cases.values())
                           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                       "graph_ms", "library_graph_ms")}
        say(f"{which} summed over a step's 20 launches: " + ", ".join(
            f"{key} {val:.3f}" for key, val in per_step[which].items()))
    return {"busy_share": windows["card"]["busy_share"], "windows": windows,
            "top": [(n, t / 1e3, c) for n, t, c in top], "cases": cases,
            "per_step": per_step}


VQ_L, FT_B = 1024, 4
VQ_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 12,
                    "flash_attention_bwd": 12, "nearest_code": 1}
FT_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 4,
                    "flash_attention_bwd": 4, "nearest_code": 2}


def _timed_steps(step, args, what, want_per_step):
    """WARMUP_STEPS steps, then TRAIN_STEPS each between its own pair of CUDA
    events, with every launch count set to 0 just before those and read just
    after. Returns (median step s, every step in s, launches, metrics of
    each step)."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    logs = [step(*args) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    kernels.reset_launch_counts()
    for start, end in pairs:
        start.record()
        logs.append(step(*args))
        end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    times = [start.elapsed_time(end) / 1e3 for start, end in pairs]
    want = {k: v * TRAIN_STEPS for k, v in want_per_step.items()}
    say(f"launches in {TRAIN_STEPS} {what} steps: {launches}")
    check(launches == want, f"{what} launches == {want} (a step: {want_per_step})")
    check(all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values()),
          f"{what}: metrics finite over {len(logs)} steps")
    return statistics.median(times), times, launches, logs


def _vq_model(seed):
    from dyadic_interaction_modeling_tpu_torch.config import vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder

    torch.manual_seed(seed)
    return VQAutoEncoder(vq_listener_defaults())


def _vq_clip(seed):
    """One synthetic listener clip of VQ_L frames, as the VQ collate gives it."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import vq_collate
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    ds = synthetic_vico_dataset(n_clips=1, min_len=VQ_L, max_len=VQ_L, seed=seed)
    return torch.as_tensor(vq_collate([(ds[0][1],)]), device="cuda")


@phase
def vq_train_main_path():
    """VQ-VAE tokenizer training at full width (vq_listener_defaults: hidden
    384, 6 + 6 layers, 8 heads of 48, 512 x 128 codes), fp32, one clip of
    1024 frames, AdamW lr 1e-4 with weight decay 0.01 (train_vq's)."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step

    model = _vq_model(seed=0).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01))
    clip = _vq_clip(seed=11)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    med, times, launches, logs = _timed_steps(step, (clip,), "VQ training", VQ_STEP_LAUNCHES)
    still = [k for k, p in model.named_parameters() if torch.equal(p, before[k])]
    check(not still, f"all {len(before)} VQ parameter tensors moved (unmoved: {still[:5]})")
    say(f"VQ train step B=1 L={VQ_L} fp32, CUDA events: median {med * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in times]} -> {VQ_L / med:.0f} frames/s")
    say(f"metrics of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (clip,), "VQ training")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


def _rounded(logs):
    return {k: round(float(v), 4) for k, v in logs.items()}


def _grad_errs(gk, gp):
    return {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gp}


@phase
def vq_train_reference():
    """One fp32 VQ step's forward and backward with the kernels and with
    their plain versions, from the same weights on the same clip: equal
    codes, losses within 1e-5 relative, gradients within 1e-3 of each
    leaf's largest magnitude. K4 runs in both (``plain_attention`` swaps the
    attention only), so its codes are held against ``nearest_code_plain`` on
    the latents it was given (``k4_on_path``)."""
    from dyadic_interaction_modeling_tpu_torch.metrics.loss import calc_vq_loss

    clip = _vq_clip(seed=12)
    state = _vq_model(seed=1).state_dict()
    results = []
    for plain in (False, True):
        model = _vq_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            dec, emb_loss, enc = model(clip)
            total, (rec, quant) = calc_vq_loss(dec, clip, emb_loss)
            total.backward()
        results.append(({"loss": float(total.detach()), "rec_loss": float(rec),
                          "quant_loss": float(quant), "perplexity": float(enc.perplexity)},
                         enc.indices, {k: p.grad for k, p in model.named_parameters()
                                       if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, "the VQ training step")
    (lk, ck, gk), (lp, cp, gp) = results
    check(torch.equal(ck, cp), f"VQ codes equal with the kernels and with the plain versions "
          f"({ck.numel()} codes)")
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 VQ step L={VQ_L}, kernels vs plain: metrics rel "
          f"err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-3, f"gradients of {len(errs)} VQ leaves within 1e-3 of each "
          f"leaf's max: worst {errs[worst]:.3g} ({worst})")
    return {"loss_rel": max(rel.values()), "grad_rel": errs[worst], "k4": k4}


SPK_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 18,
                     "flash_attention_bwd": 18, "nearest_code": 1}


def _spk_model(seed):
    from dyadic_interaction_modeling_tpu_torch.config import vq_speaker_defaults
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder

    torch.manual_seed(seed)
    return VQSpeakerAutoEncoder(vq_speaker_defaults())


def _spk_clip(seed):
    """One synthetic audio-visual clip of VQ_L frames, listener motion ||
    audio (824 features), as ``train_vq``'s synthetic AV stream makes it."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    combined, listener = synthetic_vico_dataset(n_clips=1, min_len=VQ_L, max_len=VQ_L,
                                                seed=seed)[0][:2]
    clip = torch.cat([torch.as_tensor(listener), torch.as_tensor(combined[:, 56:])], dim=1)
    return clip[None].to("cuda")


@phase
def speaker_vq_train_main_path():
    """The audio-visual speaker VQ-VAE's training at full width
    (vq_speaker_defaults: hidden 768, 6 + 6 + 6 layers, 8 heads of 96,
    512 x 128 codes, 8 codes a frame), fp32, one clip of 1024 frames, AdamW
    lr 1e-4 with weight decay 0.01 (train_vq's), the split AV loss. A step
    runs K2 and K3 once in each of the 18 attention layers (encoder,
    decoder_v, decoder_a) and K4 once, at N = 8 x 1024 latents."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step

    model = _spk_model(seed=0).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01), audio_visual=True)
    clip = _spk_clip(seed=21)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    med, times, launches, logs = _timed_steps(step, (clip,), "speaker VQ training",
                                              SPK_STEP_LAUNCHES)
    still = [k for k, p in model.named_parameters() if torch.equal(p, before[k])]
    check(not still, f"all {len(before)} speaker VQ parameter tensors moved "
          f"(unmoved: {still[:5]})")
    say(f"speaker VQ train step B=1 L={VQ_L} fp32, CUDA events: median {med * 1e3:.2f} ms "
        f"of {[round(t * 1e3, 2) for t in times]} -> {VQ_L / med:.0f} frames/s")
    say(f"metrics of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (clip,), "speaker VQ training")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


@phase
def speaker_vq_train_reference():
    """The speaker VQ's step on one AV clip of VQ_L frames, three times from
    the same weights: fp32 with the kernels, fp32 with the plain versions,
    and the plain versions in fp64 (``fp64_where_fp32``; the first run's
    codes stand in K4's place, which takes fp32 only). Between the fp32
    runs: codes equal, metrics within 1e-5 relative. Gradients, relative to
    each leaf's largest magnitude: on the leaves where the plain fp32 run is
    within 1e-4 of fp64, the kernels within 1e-3 of the plain fp32 run; on
    every leaf, the kernels' error against fp64 within 1e-3 or within 4x the
    plain fp32 run's. Some leaves of this model lose digits to cancellation
    in fp32 whatever computes the attention (the sums over the frames that
    share a code, the instance norms of the conv blocks): there two fp32 runs
    differ by more than 1e-3 and only fp64 tells which is right. K4's codes
    are held against ``nearest_code_plain`` on the latents it was given."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.metrics.loss import calc_vq_loss_AV
    from dyadic_interaction_modeling_tpu_torch.ops import quantizer

    clip = _spk_clip(seed=22)
    state = _spk_model(seed=1).state_dict()
    runs, codes = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = _spk_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(plain_attention() if plain else k4_calls())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
                stack.enter_context(mock.patch.object(quantizer, "_nearest_code",
                                                      lambda z, e: codes))
            dec, emb_loss, enc = model(clip.to(dtype))
            total, (rec, quant) = calc_vq_loss_AV(dec, clip.to(dtype), emb_loss)
            total.backward()
        if not plain:
            k4 = k4_on_path(calls, "the speaker VQ step")
            codes = enc.indices.reshape(-1)
        runs.append(({"loss": float(total.detach()), "rec_loss": float(rec),
                      "quant_loss": float(quant), "perplexity": float(enc.perplexity)},
                     enc.indices, {k: p.grad.double() for k, p in model.named_parameters()
                                   if p.grad is not None}))
        del model
    (lk, ck, gk), (lp, cp, gp), (_, _, g64) = runs
    check(torch.equal(ck, cp), f"speaker VQ codes equal with the kernels and with the plain "
          f"versions ({ck.numel()} codes)")
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 speaker VQ step L={VQ_L}, kernels vs plain: "
          f"metrics rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    ek, ep, ekp = _grad_errs(gk, g64), _grad_errs(gp, g64), _grad_errs(gk, gp)
    sound = [k for k in g64 if ep[k] <= 1e-4]
    worst = max(sound, key=ekp.get)
    check(ekp[worst] <= 1e-3, f"gradients of the {len(sound)} speaker VQ leaves where the "
          f"plain fp32 run is within 1e-4 of fp64: kernels vs plain within 1e-3 of each "
          f"leaf's max, worst {ekp[worst]:.3g} ({worst})")
    lossy = sorted((k for k in g64 if k not in sound), key=ep.get, reverse=True)
    for k in lossy[:6]:
        say(f"  {k}: off fp64 by {ek[k]:.3g} (kernels) and {ep[k]:.3g} (plain fp32); "
            f"kernels vs plain {ekp[k]:.3g}")
    bad = [k for k in g64 if ek[k] > max(1e-3, 4 * ep[k])]
    check(not bad, f"speaker VQ gradients against fp64: the kernels' error within 1e-3 or 4x "
          f"the plain fp32 run's on each of {len(g64)} leaves ({len(lossy)} leaves where "
          f"the plain fp32 run is past 1e-4; worst kernel error {max(ek.values()):.3g}, "
          f"plain fp32 {max(ep.values()):.3g}; failing: {bad[:5]})")
    return {"loss_rel": max(rel.values()), "grad_rel": ekp[worst], "k4": k4,
            "kernels_vs_fp64": max(ek.values()), "plain_fp32_vs_fp64": max(ep.values()),
            "lossy_leaves": {k: {"kernels": ek[k], "plain_fp32": ep[k],
                                 "kernels_vs_plain": ekp[k]} for k in lossy}}


def _finetune_batch(lens, seed, moving_speaker=False):
    """FT_B synthetic clips of L frames, as one batch on the card, with the
    key mask of ``lens``: ViCo-shaped (whose speaker motion is constant, as
    the synthetic ViCo set makes it), or with ``moving_speaker`` the same
    layout with smooth speaker motion (the synthetic CANDOR set). Under a
    constant speaker the speaker encoders' query and key gradients cancel to
    ~1e-6 of their value gradients, too little to hold two runs' rounding
    against, so the kernel-vs-plain comparison takes moving speakers."""
    batch = _candor(FT_B, seed) if moving_speaker else (
        torch.as_tensor(x, device="cuda") for x in _clips(FT_B, seed)[0][:4])
    src_v, tgt, src_a, _ = batch
    mask = torch.arange(L, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return src_v, tgt, src_a, mask


@phase
def finetune_main_path():
    """The SLMFT listener finetune at full width (slm_defaults +
    vq_listener_defaults): fp32 parameters under bf16 autocast, FT_B clips of
    L = 256, AdamW lr 1e-5 with weight decay 0.01, clip 1.0, both VQs frozen
    (finetune_s2s_pretrain's)."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT_FROZEN

    model = _model(torch.float32, seed=0)[0].to("cuda")
    opt = make_optimizer(model, 1e-5, 0.01, SLMFT_FROZEN)
    step = make_slm_train_step(model, opt, 1.0, torch.bfloat16)
    batch = _finetune_batch([L] * FT_B, seed=13)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(0)
    med, times, launches, logs = _timed_steps(step, (batch, g), "finetune", FT_STEP_LAUNCHES)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(k.startswith(SLMFT_FROZEN) for k in frozen)
          and all(torch.equal(model.get_parameter(k), before[k]) for k in frozen),
          f"{len(frozen)} frozen VQ tensors bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith(("encoder_", "decoder_joint"))]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable transformer tensors moved "
          f"(unmoved: {still[:5]})")
    say(f"SLMFT finetune step B={FT_B} L={L} bf16 autocast, CUDA events: median "
        f"{med * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]} -> "
        f"{FT_B * L / med:.0f} frames/s")
    say(f"logs of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (batch, g), "finetune")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


@phase
def finetune_reference():
    """One fp32 finetune step at FT_B clips of ragged lengths (128-256), with
    the kernels and with the plain versions, from the same weights and
    corruption noise: equal codes, losses within 1e-5 relative, gradients
    within 1e-3 of each leaf's largest magnitude; K4's codes against the
    plain version on the latents it was given."""
    what = "the finetune step"
    batch = _finetune_batch([L, 211, 170, 128], seed=14, moving_speaker=True)
    state = _model(torch.float32, seed=1)[0].state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)
    results, codes = [], []
    for plain in (False, True):
        model = _model(torch.float32, seed=1)[0]
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            with torch.no_grad():
                codes.append(model.forward_vq(batch[0], batch[1], batch[3]))
            out = model(*batch, noise=noise)
            out.total_loss.backward()
        logs = {k: float(v) for k, v in out.logs.items() if k in ("l_ce_l", "l_cont_l")}
        logs["total"] = float(out.total_loss.detach())
        results.append((logs, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, what)
    check(all(torch.equal(a, b) for a, b in zip(*codes)),
          "both runs' speaker and listener VQ codes equal")
    (lk, gk), (lp, gp) = results
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 finetune step B={FT_B} ragged, kernels vs plain: "
          f"losses rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-3, f"gradients of {len(errs)} leaves within 1e-3 of each leaf's "
          f"max: worst {errs[worst]:.3g} ({worst})")
    return {"loss_rel": max(rel.values()), "grad_rel": errs[worst], "k4": k4}


@contextlib.contextmanager
def fp64_where_fp32():
    """Inside, ``Tensor.float()`` leaves an fp64 tensor as it is, so that a
    model run in fp64 stays in fp64 where it rounds to fp32 on purpose
    (attention scores and softmax, the cross-entropy's log-softmax)."""
    from unittest import mock

    to_float = torch.Tensor.float

    def keep64(x, *args, **kwargs):
        return x if x.dtype == torch.float64 else to_float(x, *args, **kwargs)

    with mock.patch.object(torch.Tensor, "float", keep64):
        yield


def finetune_grads_fp64(make_model, batch, noise):
    """The gradients of one finetune loss, from the same weights, VQ codes
    and corruption noise: fp32 with the kernels, fp32 with the plain
    versions, and the plain versions in fp64 (``fp64_where_fp32``). The
    first run's VQ codes stand in all three, so that a run in another dtype
    cannot take another code at a tie."""
    runs, codes = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = make_model().to(batch[0].device, dtype)
        if codes is None:
            with torch.no_grad():
                codes = model.forward_vq(batch[0], batch[1], batch[3])
        model.forward_vq = lambda *args: codes
        inputs = [x.to(dtype) if x.is_floating_point() else x for x in batch]
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_attention())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
            model(*inputs, noise=noise).total_loss.backward()
        runs.append({k: p.grad.double() for k, p in model.named_parameters()
                     if p.grad is not None})
        del model
    return runs


@phase
def finetune_fp64_reference():
    """The ViCo-shaped clips (a constant speaker) at ragged lengths
    (128-256), which ``finetune_reference`` does not take: there the speaker
    encoder's query and key gradients cancel (``_finetune_batch``), so that
    fp32 rounding alone moves them by percents of their largest magnitude.
    Both fp32 runs, with the kernels and with the plain versions, are held
    against the plain versions in fp64: on every leaf the kernels' error,
    relative to the fp64 leaf's largest magnitude, is within 1e-3 or within
    4x the plain fp32 run's error on that leaf."""
    batch = _finetune_batch([L, 211, 170, 128], seed=14)
    state = _model(torch.float32, seed=1)[0].state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)

    def make_model():
        model = _model(torch.float32, seed=1)[0]
        model.load_state_dict(state)
        return model

    gk, gp, g64 = finetune_grads_fp64(make_model, batch, noise)
    ek, ep, ekp = _grad_errs(gk, g64), _grad_errs(gp, g64), _grad_errs(gk, gp)
    worst = max(ekp, key=ekp.get)
    say(f"kernels vs plain, both fp32: worst {ekp[worst]:.3g} of the leaf's max ({worst})")
    hard = sorted((k for k in g64 if ep[k] > 1e-3), key=ep.get, reverse=True)
    big = max(float(x.abs().max()) for x in g64.values())
    rows = {}
    for k in hard:
        v = k.replace(".to_q.", ".to_v.").replace(".to_k.", ".to_v.")
        rows[k] = {"kernels": ek[k], "plain_fp32": ep[k], "fp64_max": float(g64[k].abs().max()),
                   "to_v_fp64_max": float(g64[v].abs().max()) if v in g64 else None}
    for k, r in list(rows.items())[:6]:
        say(f"  {k}: off fp64 by {r['kernels']:.3g} (kernels) and {r['plain_fp32']:.3g} "
            f"(plain fp32) of its largest fp64 magnitude {r['fp64_max']:.3g} "
            f"(its layer's to_v: {r['to_v_fp64_max']}; largest of all leaves {big:.3g})")
    easy = [k for k in g64 if k not in rows]
    rest = max(easy, key=ek.get)
    say(f"the other {len(easy)} leaves: the kernels within {ek[rest]:.3g} of fp64 ({rest}), "
        f"the plain fp32 run within {max(ep[k] for k in easy):.3g}")
    bad = [k for k in g64 if ek[k] > max(1e-3, 4 * ep[k])]
    ratio = max(ek[k] / ep[k] for k in hard) if hard else None
    check(not bad, f"fp32 finetune step on ViCo-shaped clips against fp64: the kernels' "
          f"error within 1e-3 or 4x the plain fp32 run's on each of {len(g64)} leaves "
          f"({len(hard)} leaves where the plain fp32 run is past 1e-3, largest ratio "
          f"{ratio}; worst kernel error {max(ek.values()):.3g}; failing: {bad[:5]})")
    return {"kernels_vs_plain_fp32": ekp[worst], "kernels_vs_plain_fp32_leaf": worst,
            "kernels_vs_fp64": max(ek.values()), "plain_fp32_vs_fp64": max(ep.values()),
            "past_1e-3": rows, "largest_ratio": ratio, "kernels_vs_fp64_other_leaves": ek[rest]}


# the least tags of each training twin's run record (tests/test_postprocess_cli.py
# _assert_observability_artifacts)
RUN_RECORD_TAGS = {
    "train_vq": ["train/rec_loss", "train/quant_loss", "train/perplexity", "val/rec_loss",
                 "val/quant_loss", "val/perplexity"],
    "train_s2s_pretrain": ["val/l_ce_l", "val/loss", "learning_rate"],
    "train_s2s": ["train/loss", "val/loss", "learning_rate"],
    "train_s2s_continuous": ["val/loss", "learning_rate"],
    "finetune_s2s_pretrain": ["val/fid_pose", "val/fid_exp", "learning_rate"],
}


def run_record(save_dir, twin):
    """Checks that ``twin`` wrote its run record into ``save_dir``:
    ``scalars.jsonl`` with at least its tags, and ``hparams.json``. Returns
    the tags written."""
    tags, hparams = set(), os.path.join(save_dir, "hparams.json")
    try:
        with open(os.path.join(save_dir, "scalars.jsonl")) as f:
            tags = {json.loads(line)["tag"] for line in f}
    except FileNotFoundError:
        pass
    missing = sorted(set(RUN_RECORD_TAGS[twin]) - tags)
    check(not missing and os.path.isfile(hparams),
          f"{twin} wrote its run record: scalars.jsonl with {len(tags)} tags (missing "
          f"{missing}), hparams.json {'present' if os.path.isfile(hparams) else 'absent'}")
    return sorted(tags)


def _reference_checkpoint(path, out):
    """The twin's state_dict at ``path`` re-saved as a reference file may
    hold it: ``{'state_dict': ...}``, nn.DataParallel's ``module.`` prefix,
    the VQ-VAEs' LayerNorms spelled gamma/beta and the x-transformers norms
    weight/bias (the spellings ``utils.checkpoint.model_state_dict`` maps)."""
    sd = {}
    for k, v in torch.load(path, map_location="cpu", weights_only=True).items():
        if ".fn.norm." in k:
            k = k.replace(".fn.norm.weight", ".fn.norm.gamma").replace(".fn.norm.bias",
                                                                       ".fn.norm.beta")
        else:
            k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        sd["module." + k] = v
    torch.save({"state_dict": sd, "epoch": 1}, out)
    return out


RF_TRAIN, RF_TEST, RF_CONVERSATIONS = 16, 25, 20


@phase
def real_files_path():
    """The four CLI twins' ``main()`` at full width on the card, on files in
    the reference's layout (``data.reference_files``) under ``../data`` of
    their working directory: ViCo, RF_TEST test clips of L = 256 (the
    generate headline's shape) and RF_TRAIN train clips of 300-511 frames
    (bucket 512, so the listener VQ's attention takes K2/K3), with integer
    ids in ``RLD_data.csv``; CANDOR, RF_CONVERSATIONS conversations x 2
    utterances of 120-250 frames. In order: ``train_vq`` (the listener VQ,
    1 epoch, prefetch 2); ``train_s2s_pretrain`` (bf16 autocast, both VQs
    from the first run's checkpoint in the reference layout, token cache,
    prefetch 2, 2 epochs: K4 in epoch 1's steps and never in epoch 2's);
    ``finetune_s2s_pretrain`` (bf16 autocast, ``--pretrained`` from the
    second's, 1 epoch); ``test_s2s_pretrain`` (``--state-dict`` from the
    third's, best-of-10 in fp32). Every launch count is set to 0 just before
    each twin and read just after. Each training twin's run record
    (``scalars.jsonl`` with the JAX CLI's tags, ``hparams.json``) is
    checked."""
    import pickle
    import shutil
    import tempfile
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import (
        finetune_s2s_pretrain, test_s2s_pretrain, train_s2s_pretrain, train_vq)
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import (
        write_candor, write_vico)

    root, cwd = tempfile.mkdtemp(prefix="real_files_"), os.getcwd()
    data, work = os.path.join(root, "data"), os.path.join(root, "work")
    runs = {}

    def drive(name, main, argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        runs[name] = {"launches": dict(kernels.LAUNCHES), "s": time.perf_counter() - t0}
        say(f"{name} on the reference files: exit {rc}, {runs[name]['s']:.1f} s, launches "
            f"{runs[name]['launches']}")
        check(rc == 0, f"{name} ran to its end on the reference files")

    try:
        train_len = [300 + (37 * i) % 212 for i in range(RF_TRAIN)]
        write_vico(data, [L] * RF_TEST + train_len, ["test"] * RF_TEST + ["train"] * RF_TRAIN,
                   seed=31)
        write_candor(data, RF_CONVERSATIONS, 2, 120, 250, seed=32)
        os.makedirs(work)
        os.chdir(work)
        drive("train_vq", train_vq.main, ["--save-path", os.path.join(root, "vq"),
                                          "--prefetch", "2", "epochs", "1"])
        got = runs["train_vq"]["launches"]
        want = {"decode_attention": 0, "flash_attention_fwd": 12 * RF_TRAIN,
                "flash_attention_bwd": 12 * RF_TRAIN, "nearest_code": RF_TRAIN + RF_TEST}
        check(got == want, f"train_vq launches == {want}: 12 K2, 12 K3 and 1 K4 a training "
              "step at L = 512, 1 K4 a validation clip at L = 256")
        records = {"train_vq": run_record(os.path.join(root, "vq"), "train_vq")}
        vq = _reference_checkpoint(os.path.join(root, "vq", "best_model.pt"),
                                   os.path.join(root, "vq.pth.tar"))
        per_epoch, real_epoch = [], train_s2s_pretrain.train_epoch

        def counted_epoch(*args, **kwargs):
            before = dict(kernels.LAUNCHES)
            out = real_epoch(*args, **kwargs)
            per_epoch.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
            return out

        with mock.patch.object(train_s2s_pretrain, "train_epoch", counted_epoch):
            drive("train_s2s_pretrain", train_s2s_pretrain.main, [
                "--dtype", "bfloat16", "--vq-token-cache", "--prefetch", "2",
                "--speaker-vq", vq, "--listener-vq", vq,
                "--save-path", os.path.join(root, "pretrain"), "epochs", "2"])
        steps = -(-(2 * RF_CONVERSATIONS - 2) // 32)  # 19 conversations train
        say(f"train_s2s_pretrain launches in each epoch's training steps: {per_epoch}")
        want = [{"decode_attention": 0, "flash_attention_fwd": 20 * steps,
                 "flash_attention_bwd": 20 * steps, "nearest_code": k4}
                for k4 in (2 * steps, 0)]
        check(per_epoch == want, f"train_s2s_pretrain with the token cache: {steps} steps an "
              "epoch, 20 K2 and 20 K3 a step, K4 twice a batch in epoch 1 and 0 times in "
              f"epoch 2: {want}")
        records["train_s2s_pretrain"] = run_record(os.path.join(root, "pretrain"),
                                                   "train_s2s_pretrain")
        pre = _reference_checkpoint(os.path.join(root, "pretrain", "best_model.pt"),
                                    os.path.join(root, "pretrain.pth.tar"))
        drive("finetune_s2s_pretrain", finetune_s2s_pretrain.main, [
            "--dtype", "bfloat16", "--pretrained", pre, "--prefetch", "2",
            "--save-path", os.path.join(root, "finetune"), "epochs", "1"])
        got = runs["finetune_s2s_pretrain"]["launches"]
        check(got["decode_attention"] == 0 and min(
            got[k] for k in ("flash_attention_fwd", "flash_attention_bwd", "nearest_code")) > 0,
              f"finetune_s2s_pretrain launched K2, K3 and K4 and no K1: {got}")
        records["finetune_s2s_pretrain"] = run_record(os.path.join(root, "finetune"),
                                                      "finetune_s2s_pretrain")
        ft = _reference_checkpoint(os.path.join(root, "finetune", "best_model.pt"),
                                   os.path.join(root, "finetune.pth.tar"))
        pred = os.path.join(root, "pred.pkl")
        drive("test_s2s_pretrain", test_s2s_pretrain.main, ["--state-dict", ft, "--out", pred])
        batches = -(-RF_TEST // 4)
        got = runs["test_s2s_pretrain"]["launches"]
        want = {"decode_attention": batches * 2 * 4 * (L - 1), "flash_attention_fwd": 0,
                "flash_attention_bwd": 0, "nearest_code": 2 * batches}
        check(got == want, f"test_s2s_pretrain launches == {want}: per batch of 4 clips, K1 "
              "for 255 tokens x 4 layers x (self, cross) and K4 for the two VQ encodes")
        with open(pred, "rb") as f:
            out = pickle.load(f)
        ok = (len(out["y_pred"]) == RF_TEST
              and all(p.shape == (L - 1, 56) and bool(torch.isfinite(torch.as_tensor(p)).all())
                      for p in out["y_pred"]))
        check(ok, f"test_s2s_pretrain: {len(out['y_pred'])} best-of-10 predictions of "
              f"({L - 1}, 56), all finite")
        return {"runs": runs, "pretrain_epochs": per_epoch, "run_record_tags": records}
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


# --- the BIWI speaker family (SpeakerSLMFT, EmocaConverter) at full width ---

BIWI_L, BIWI_N, BIWI_CLIPS, BIWI_B, BIWI_VDIM = 120, 50, 4, 4, 70110
BIWI_GEN_LAUNCHES = {"decode_attention": 8 * (BIWI_L - 1), "flash_attention_fwd": 0,
                     "flash_attention_bwd": 0, "nearest_code": 2}
BIWI_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 4,
                      "flash_attention_bwd": 4, "nearest_code": 2}
# half the mesh's vertices, as test_biwi's synthetic mouth map
BIWI_MOUTH = list(range(BIWI_VDIM // 6))


def _speaker_model(seed):
    """SpeakerSLMFT at full width (slm_defaults + vq_listener_defaults, 70110-d
    BIWI meshes, 15 speakers), fp32, seeded random weights."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SpeakerSLMFT

    torch.manual_seed(seed)
    return SpeakerSLMFT(slm_defaults(), vq_listener_defaults(), vertice_dim=BIWI_VDIM,
                        n_speakers=15)


def _biwi_batch(n_clips, seed):
    """n_clips synthetic BIWI clips of BIWI_L frames (about 4.8 s at BIWI's 25
    fps) as one batch on the card: (vertices, EMOCA, audio features, mask,
    template, speaker ids)."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import (
        synthetic_biwi_dataset, synthetic_vico_dataset)
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import speaker_ids_from_names

    items, _ = synthetic_biwi_dataset(n_clips=n_clips, length=BIWI_L,
                                      n_vertices=BIWI_VDIM // 3, seed=seed)
    emoca = synthetic_vico_dataset(n_clips=n_clips, min_len=BIWI_L, max_len=BIWI_L, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def stack(xs):
        return torch.stack([torch.as_tensor(x) for x in xs]).to("cuda")

    return (stack([it["vertice"] for it in items]), stack([emoca[i][1] for i in range(n_clips)]),
            torch.randn(n_clips, BIWI_L, 768, device="cuda", generator=g),
            torch.ones(n_clips, BIWI_L, dtype=torch.bool, device="cuda"),
            stack([it["template"] for it in items]),
            speaker_ids_from_names([it["name"] for it in items], "cuda"))


@phase
def speaker_generate_path():
    """SpeakerSLMFT best-of-BIWI_N generation at full width, fp32, one clip a
    call as the reference evaluates (batch 1): ``make_speaker_generator``,
    then ``select_best_by_l2``, each call with every launch count set to 0
    just before it and read just after (K1 8 x (L - 1): self and cross in 4
    decoder layers for L - 1 tokens; K4 twice; no K2/K3). Then one greedy
    token sequence at B0 = 1, N = BIWI_N teacher-forced through
    ``decode_step`` with the kernels and with the plain versions (logits
    within 1e-3), and K1 at the cross step's shape, (12, BIWI_N, 64) over
    BIWI_L keys with a key mask, against its plain version (fp32 1e-5, bf16
    2e-2)."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        make_speaker_generator, select_best_by_l2)
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    model = _speaker_model(seed=0).to("cuda").eval()
    gen = make_speaker_generator(model)
    batch = _biwi_batch(BIWI_CLIPS, seed=21)
    rng = torch.Generator(device="cuda").manual_seed(0)
    runs, times = [], []
    for i in range(BIWI_CLIPS):
        clip = tuple(x[i: i + 1] for x in batch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cands = gen(clip, rng, BIWI_N)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        runs.append(dict(kernels.LAUNCHES))
        best = select_best_by_l2(cands[0].cpu().numpy(), clip[1][0, 1:].cpu().numpy())
        check(tuple(cands.shape) == (1, BIWI_N, BIWI_L - 1, 56)
              and bool(torch.isfinite(cands).all()) and best.shape == (BIWI_L - 1, 56),
              f"speaker best-of-{BIWI_N} clip {i}: candidates {tuple(cands.shape)} finite, "
              f"best by L2 {best.shape}")
    say(f"launches of each speaker generate call: {runs}")
    check(all(r == BIWI_GEN_LAUNCHES for r in runs),
          f"each speaker generate call launches {BIWI_GEN_LAUNCHES} (K1 self and cross at "
          f"NQ = {BIWI_N} in 4 layers x {BIWI_L - 1} tokens, K4 for the two VQ encodes)")
    med = statistics.median(times)
    say(f"speaker best-of-{BIWI_N}, 1 clip x L={BIWI_L}, fp32, {CARD[-1]}: median "
        f"{med * 1e3:.1f} ms of "
        f"{[round(t * 1e3, 1) for t in times]} -> {BIWI_N * (BIWI_L - 1) / med:.0f} sampled "
        "frames/s")

    clip = tuple(x[:1] for x in batch)
    with torch.no_grad():
        tokens = gen(clip, None, BIWI_N, greedy=True, return_tokens=True)[1]
        ctx, prompt = model.encode_context(*clip)
        dec = model.decoder
        cross = dec.cross_kv(ctx)
        seq = torch.cat([prompt.repeat(BIWI_N, 1).to(tokens.dtype), tokens], dim=1)
        caches = [init_decoder_cache(BIWI_N, BIWI_L, dec.depth, dec.heads, dec.dim_head,
                                     torch.float32, dec.kv_heads, "cuda") for _ in range(2)]
        worst = 0.0
        for t in range(BIWI_L):
            tok = seq[:, t: t + 1]
            a = dec.decode_step(tok, caches[0], t, cross, clip[3], BIWI_N)
            with plain_attention():
                b = dec.decode_step(tok, caches[1], t, cross, clip[3], BIWI_N)
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"speaker teacher-forced decode_step fp32 B0=1 N={BIWI_N}, {BIWI_L} "
          f"steps of the greedy sequence: logits max abs err kernel vs plain {worst:.3g} "
          "(tol 1e-3)")

    g = torch.Generator(device="cuda").manual_seed(22)
    k1 = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn(HEADS, BIWI_N, 64, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(HEADS, BIWI_L, 64, device="cuda", generator=g).to(dtype)
                for _ in range(2))
        mask = torch.rand(1, BIWI_L, device="cuda", generator=g) < 0.8
        mask[:, 0] = True
        e = float((decode_attention(q, k, v, None, mask, scale=0.125).float()
                   - decode_attention_plain(q, k, v, None, mask, scale=0.125).float())
                  .abs().max())
        tag = str(dtype).replace("torch.", "")
        check(e <= tol, f"K1 speaker cross {tag} ({HEADS},{BIWI_N},64) over {BIWI_L} keys, "
              f"key mask: max abs err {e:.3g} (tol {tol})")
        k1[tag] = e
    return {"launches": runs[0], "launches_each_call": runs, "generate_ms": med * 1e3,
            "generate_runs_ms": [t * 1e3 for t in times], "teacher_forced_err": worst,
            "k1_cross_err": k1}


def _stdout_of(main, argv):
    """``main(argv)``'s exit code and what it printed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    say(buf.getvalue().rstrip())
    return rc, buf.getvalue()


@phase
def test_biwi_twin():
    """``cli/test_biwi.main`` with ``--synthetic`` at full width on the card
    (4 clips of 16 frames, 70110-d meshes, fp32), every launch count set to
    0 just before and read just after (a clip: K2 4 in the decoder's causal
    self-attention, K4 2); its gt/pred ``.npy`` files and finite LVE / FDD;
    then the same run under ``plain_attention()``: every teacher-forced
    prediction within 1e-4 of the kernels' relative to its largest
    magnitude."""
    import shutil
    import tempfile

    import numpy as np

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import test_biwi

    root = tempfile.mkdtemp(prefix="test_biwi_")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = _stdout_of(test_biwi.main, ["--synthetic", "--out-dir",
                                              os.path.join(root, "kernels")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n = test_biwi.SYNTHETIC_CLIPS
        want = {"decode_attention": 0, "flash_attention_fwd": 4 * n, "flash_attention_bwd": 0,
                "nearest_code": 2 * n}
        say(f"test_biwi: exit {rc}, {secs:.1f} s, launches {launches}")
        check(rc == 0 and launches == want, f"test_biwi ran to its end with launches {want} "
              "(a clip: K2 in 4 decoder layers, K4 for the two VQ encodes)")
        lve, fdd = (float(x) for x in out.split("LVE ")[1].split()[::2][:2])
        check(all(v == v and abs(v) != float("inf") for v in (lve, fdd)),
              f"test_biwi LVE {lve:.6e} and FDD {fdd:.6e} finite")
        with plain_attention():
            _stdout_of(test_biwi.main, ["--synthetic", "--out-dir", os.path.join(root, "plain")])
        files = sorted(os.listdir(os.path.join(root, "kernels", "pred")))
        worst = 0.0
        for f in files:
            a, b = (np.load(os.path.join(root, d, "pred", f)) for d in ("kernels", "plain"))
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        gts = [np.load(os.path.join(root, "kernels", "gt", f)) for f in files]
        check(len(files) == n and all(g.shape == (test_biwi.SYNTHETIC_LEN - 1, 56) for g in gts),
              f"test_biwi wrote {len(files)} gt and pred files of "
              f"({test_biwi.SYNTHETIC_LEN - 1}, 56)")
        check(worst <= 1e-4, f"test_biwi teacher-forced predictions, kernels vs plain: "
              f"{worst:.3g} of the largest magnitude (tol 1e-4)")
        return {"launches": launches, "s": secs, "lve": lve, "fdd": fdd, "pred_rel": worst}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _speaker_grads(state, batch, codes, plain, dtype):
    """One SpeakerSLMFT loss and its trainable leaves' gradients, from
    ``state`` and the given target ``codes``, with the kernels or the plain
    versions, in fp32 or fp64 (``fp64_where_fp32``)."""
    from dyadic_interaction_modeling_tpu_torch.models.slm import SPEAKER_SLMFT_FROZEN

    model = _speaker_model(seed=0)
    model.load_state_dict(state)
    model = model.to("cuda", dtype)
    for k, p in model.named_parameters():
        p.requires_grad_(not k.startswith(SPEAKER_SLMFT_FROZEN))
    model._codes = lambda *args: codes
    inputs = [x.to(dtype) if x.is_floating_point() else x for x in batch]
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_attention())
        if dtype == torch.float64:
            stack.enter_context(fp64_where_fp32())
        out = model(*inputs, mouth_map=BIWI_MOUTH)
        out.total_loss.backward()
    logs = {k: float(out.logs[k].detach()) for k in ("l_ce_l", "l_cont_l")}
    logs["total"] = float(out.total_loss.detach())
    grads = {k: p.grad.double() for k, p in model.named_parameters() if p.grad is not None}
    return logs, grads


@phase
def speaker_finetune_path():
    """One SpeakerSLMFT finetune step at full width: fp32, AdamW (1e-5,
    weight decay 0.01), clip 1.0, SPEAKER_SLMFT_FROZEN frozen, BIWI_B clips
    of BIWI_L frames with the mouth MSE logged: 3 warmup steps and 10 steps
    each between its own pair of CUDA events (K2 4, K3 4, K4 2 a step),
    frozen tensors bitwise unchanged, then traced as the other steps. Then
    one fp32 loss with the kernels and with the plain versions from the same
    weights: equal codes, loss within 1e-5 relative, gradients of the
    trainable leaves within 1e-3 of each leaf's largest magnitude; a leaf
    past that is held against the plain versions in fp64 as in 11 (the
    kernels' error within 1e-3 or 4x the plain fp32 run's)."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_speaker_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SPEAKER_SLMFT_FROZEN

    model = _speaker_model(seed=0).to("cuda")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, 1e-5, 0.01, SPEAKER_SLMFT_FROZEN)
    step = make_speaker_train_step(model, opt, 1.0)
    batch = _biwi_batch(BIWI_B, seed=23)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    med, times, launches, logs = _timed_steps(step, (batch, BIWI_MOUTH), "speaker finetune",
                                              BIWI_STEP_LAUNCHES)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(k.startswith(SPEAKER_SLMFT_FROZEN) for k in frozen)
          and all(torch.equal(model.get_parameter(k), before[k]) for k in frozen),
          f"{len(frozen)} frozen speaker tensors bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith(("decoder_joint", "speaker_vq.decoder.decoder_transformer"))]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable transformer tensors moved "
          f"(unmoved: {still[:5]})")
    say(f"SpeakerSLMFT finetune step B={BIWI_B} L={BIWI_L} fp32, {CARD[-1]}, CUDA events: median "
        f"{med * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]} -> "
        f"{BIWI_B * BIWI_L / med:.0f} frames/s")
    say(f"logs of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (batch, BIWI_MOUTH), "speaker finetune")
    del model, opt, step
    torch.cuda.empty_cache()

    codes = []
    for plain in (False, True):
        m = _speaker_model(seed=0)
        m.load_state_dict(state)
        m = m.to("cuda")
        with plain_attention() if plain else k4_calls() as calls, torch.no_grad():
            codes.append(m._codes(batch[0], batch[1], batch[3], batch[4]))
        if not plain:
            k4 = k4_on_path(calls, "the speaker finetune step")
        del m
    check(torch.equal(*codes), "both runs' EMOCA codes equal")
    (lk, gk), (lp, gp) = (_speaker_grads(state, batch, codes[0], plain, torch.float32)
                          for plain in (False, True))
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 speaker finetune loss B={BIWI_B}, kernels vs "
          f"plain: rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    hard = [k for k in errs if errs[k] > 1e-3]
    say(f"gradients of {len(errs)} trainable leaves, kernels vs plain fp32: worst "
        f"{errs[worst]:.3g} of the leaf's max ({worst}); past 1e-3: {hard[:6]}")
    fp64 = None
    if hard:
        _, g64 = _speaker_grads(state, batch, codes[0], True, torch.float64)
        ek, ep = _grad_errs(gk, g64), _grad_errs(gp, g64)
        bad = [k for k in hard if ek[k] > max(1e-3, 4 * ep[k])]
        fp64 = {k: {"kernels": ek[k], "plain_fp32": ep[k]} for k in hard}
        check(not bad, f"the {len(hard)} leaves past 1e-3 against fp64: the kernels' error "
              f"within 1e-3 or 4x the plain fp32 run's (failing: {bad[:5]})")
    else:
        check(True, f"gradients of the {len(errs)} trainable leaves within 1e-3 of each "
              "leaf's max, kernels vs plain fp32")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top],
            "loss_rel": max(rel.values()), "grad_rel": errs[worst], "grad_rel_leaf": worst,
            "fp64": fp64, "k4": k4}


@phase
def converter_path():
    """``cli/train_converter.main`` at full width on the card: 70110-d meshes,
    8 synthetic clips of BIWI_L frames, a mouth map, 2 epochs, every launch
    count set to 0 just before and read just after (K4 once a step: the
    frozen speaker VQ's encode; its attention at L = 120 takes the matmul
    route); finite losses that fall, the speaker VQ bitwise unchanged in the
    best state_dict. Then the step alone: 3 warmup steps and 10 each between
    its own pair of CUDA events, traced as the other steps."""
    import shutil
    import tempfile

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import train_converter as tc
    from dyadic_interaction_modeling_tpu_torch.config import vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import CONVERTER_FROZEN, EmocaConverter

    root = tempfile.mkdtemp(prefix="converter_")
    try:
        mouth = os.path.join(root, "lve.txt")
        with open(mouth, "w") as f:
            f.write(", ".join(str(i) for i in BIWI_MOUTH))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = _stdout_of(tc.main, ["--synthetic", "--clip-len", str(BIWI_L),
                                       "--mouth-map", mouth, "--epochs", "2",
                                       "--save-path", os.path.join(root, "run")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        want = {"decode_attention": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "nearest_code": 16}
        say(f"train_converter: exit {rc}, {secs:.1f} s, launches {launches}")
        check(rc == 0 and launches == want, f"train_converter ran to its end with launches "
              f"{want} (8 clips x 2 epochs, K4 once a step)")
        losses = [float(line.split("loss ")[1]) for line in out.splitlines() if "loss " in line]
        check(len(losses) == 2 and all(x == x and abs(x) != float("inf") for x in losses)
              and losses[1] < losses[0], f"train_converter epoch losses {losses} finite and "
              "falling")
        torch.manual_seed(0)
        init = EmocaConverter(vq_listener_defaults(), BIWI_VDIM).state_dict()
        best = torch.load(os.path.join(root, "run", "best_model.pt"), map_location="cpu",
                          weights_only=True)
        vq = [k for k in best if k.startswith(CONVERTER_FROZEN)]
        check(bool(vq) and all(torch.equal(best[k], init[k]) for k in vq),
              f"the converter's {len(vq)} speaker VQ tensors bitwise unchanged")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.manual_seed(0)
    model = EmocaConverter(vq_listener_defaults(), BIWI_VDIM).to("cuda")
    step = tc.make_converter_step(model, make_optimizer(model, 1e-5, 0.01, CONVERTER_FROZEN),
                                  0.0, BIWI_MOUTH, 5.0)
    args = tuple(torch.as_tensor(x, device="cuda")
                 for x in tc.synthetic_batches(BIWI_VDIM, BIWI_L, n_clips=1)[0])

    def logged(*a):
        return {"loss": step(*a)}

    med, times, steps, _ = _timed_steps(logged, args, "converter", {
        "decode_attention": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "nearest_code": 1})
    say(f"converter step B=1 L={BIWI_L} fp32, {CARD[-1]}, CUDA events: median "
        f"{med * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]} -> "
        f"{BIWI_L / med:.0f} frames/s")
    windows, top = _trace_steps(logged, args, "converter")
    return {"launches": launches, "s": secs, "losses": losses, "step_ms": med * 1e3,
            "step_runs_ms": [t * 1e3 for t in times], "step_launches": steps,
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


@phase
def speaker_timings():
    """K1 at the speaker generate path's shapes, fp32 (its dtype): the cross
    step (12, BIWI_N, 64) over BIWI_L keys with the clip's key mask, and the
    self step (BIWI_N x 12, 1, 64) swept over t = 0 .. BIWI_L - 2 (the mean
    launch of a call); the kernel, its plain version and SDPA, as in 9."""
    import torch.nn.functional as F

    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(24)
    f32 = torch.float32
    out = {}
    rows = BIWI_N * HEADS
    sets = [tuple(torch.randn(rows, n, 64, device="cuda", generator=g) for n in (1, BIWI_L, BIWI_L))
            for _ in range(4)]
    steps = BIWI_L - 1

    def sweep(fn):
        return lambda i=0: [fn(*sets[(i + t) % 4], t) for t in range(steps)]

    kern = sweep(lambda q, k, v, t: decode_attention(q, k, v, t, scale=0.125))
    plain = sweep(lambda q, k, v, t: decode_attention_plain(q, k, v, t, scale=0.125))
    sdpa = sweep(lambda q, k, v, t: F.scaled_dot_product_attention(
        q[:, None], k[:, None, : t + 1], v[:, None, : t + 1], scale=0.125))
    r = dict(ms=cuda_ms(kern, 7) / steps, plain_ms=cuda_ms(plain, 3) / steps,
             library_ms=cuda_ms(sdpa, 7) / steps, graph_ms=graph_ms(kern, inner=1) / steps,
             library_graph_ms=graph_ms(sdpa, inner=1) / steps)
    nbytes = sum(rows * 64 * 4 * 2 * (t + 1) for t in range(steps)) / steps + 2 * rows * 64 * 4
    ops = sum(4 * rows * 64 * (t + 1) for t in range(steps)) / steps
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, ops, f32)
    out["speaker_self"] = r
    del sets
    q = torch.randn(HEADS, BIWI_N, 64, device="cuda", generator=g)
    k, v = (torch.randn(HEADS, BIWI_L, 64, device="cuda", generator=g) for _ in range(2))
    mask = torch.ones(1, BIWI_L, dtype=torch.bool, device="cuda")
    m4 = mask.repeat_interleave(HEADS, 0)[:, None, None, :]
    r = dict(ms=cuda_ms(lambda i: decode_attention(q, k, v, None, mask, scale=0.125), 200),
             plain_ms=cuda_ms(lambda i: decode_attention_plain(q, k, v, None, mask,
                                                               scale=0.125), 50),
             library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                 q[:, None], k[:, None], v[:, None], attn_mask=m4, scale=0.125), 200),
             graph_ms=graph_ms(lambda: decode_attention(q, k, v, None, mask, scale=0.125)),
             library_graph_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                 q[:, None], k[:, None], v[:, None], attn_mask=m4, scale=0.125)))
    nbytes = HEADS * BIWI_L * 64 * 4 * 2 + 2 * HEADS * BIWI_N * 64 * 4 + BIWI_L
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 4 * HEADS * BIWI_N * BIWI_L * 64, f32)
    out["speaker_cross"] = r
    for name, r in out.items():
        say(f"K1 {name} fp32, {CARD[-1]}: kernel {r['ms'] * 1e3:.2f} us (graph "
            f"{r['graph_ms'] * 1e3:.2f} "
            f"us), plain {r['plain_ms'] * 1e3:.2f} us, SDPA {r['library_ms'] * 1e3:.2f} us "
            f"(graph {r['library_graph_ms'] * 1e3:.2f} us), bound {r['bound_ms'] * 1e3:.2f} "
            f"us ({r['bound_by']})")
    return out


# --- the seq2seq listener path (ListenerGenerator) and the streaming sessions ---

S2S_B, S2S_STEP_LAUNCHES = 4, {"decode_attention": 0, "flash_attention_fwd": 12,
                               "flash_attention_bwd": 12, "nearest_code": 2}
# a test_s2s batch: K1 for the self and the cross step of 6 decoder layers a
# code, K2 in the 6 encoder layers (no attn_mask), K4 for the two VQ encodes
S2S_GEN_LAUNCHES = {"decode_attention": (L - 1) * 6 * 2, "flash_attention_fwd": 6,
                    "flash_attention_bwd": 0, "nearest_code": 2}
S2S_RF_TRAIN, S2S_RF_TEST = 8, 4


def _lg_model(seed, with_ids=True):
    """ListenerGenerator at full width (listener_generator_defaults: dim 512,
    6 + 6 layers, 8 heads of 64, 512 codes, enc_max_seq_len 1024; both VQs
    vq_listener_defaults), fp32, seeded random weights."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        lg_vq_cfg, listener_generator_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.listener_generator import (
        ListenerGenerator)

    cfg = listener_generator_defaults()
    vq = lg_vq_cfg(cfg)
    torch.manual_seed(seed)
    return ListenerGenerator(cfg, vq, vq, with_ids=with_ids)


def _lg_batch(seed, lens=None, moving_speaker=False):
    """S2S_B clips of L frames as (src_v, tgt, mask, speaker ids, listener
    ids) on the card: synthetic ViCo clips (their speaker motion constant,
    as ViCo's reader makes it) with their ids, or with ``moving_speaker``
    CANDOR-shaped ones (see ``_finetune_batch`` on why a gradient check
    takes those) with ids 0-3; ``lens`` gives the key mask."""
    if moving_speaker:
        src_v, tgt, _, mask = _candor(S2S_B, seed)
        ids = torch.arange(S2S_B, device="cuda")
        sp, li = ids, ids.flip(0)
    else:
        src_v, tgt, _, mask, names = _clips(S2S_B, seed)[0]
        src_v, tgt, mask = (torch.as_tensor(x, device="cuda") for x in (src_v, tgt, mask))
        n = torch.arange(S2S_B, device="cuda")
        sp, li = n % 7, n % 5  # the synthetic set's ids
    if lens is not None:
        mask = torch.arange(L, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return src_v, tgt, mask, sp, li


@phase
def s2s_train_path():
    """The ListenerGenerator training step at full width, fp32 (the JAX
    CLI's dtype), S2S_B synthetic ViCo clips of L = 256 with ids, AdamW 1e-5,
    weight decay 0.01, no clip, ``LG_FROZEN``: steps timed and traced as the
    other steps, with 12 K2 and 12 K3 (the 6 encoder layers at (32, 257, 64)
    with the key mask, the 6 causal decoder layers at (32, 256, 64)) and 2 K4
    (the two VQ encodes) a step; finite losses, the frozen VQ parts bitwise
    unchanged, every trainable generator tensor moved."""
    from dyadic_interaction_modeling_tpu_torch.engine.s2s_engine import make_lg_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.listener_generator import LG_FROZEN

    model = _lg_model(seed=0).to("cuda")
    lg_step = make_lg_train_step(model, make_optimizer(model, 1e-5, 0.01, LG_FROZEN), 0.0,
                                 use_ids=True)

    def step(batch):
        return {"loss": lg_step(batch)}

    batch = _lg_batch(seed=41)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    med, times, launches, logs = _timed_steps(step, (batch,), "s2s train", S2S_STEP_LAUNCHES)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(k.startswith(LG_FROZEN) for k in frozen)
          and all(torch.equal(model.get_parameter(k), before[k]) for k in frozen),
          f"{len(frozen)} frozen VQ tensors (LG_FROZEN) bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith("generator.")]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable generator tensors moved "
          f"(unmoved: {still[:5]})")
    say(f"s2s train step B={S2S_B} L={L} fp32, {CARD[-1]}, CUDA events: median "
        f"{med * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]} -> "
        f"{S2S_B * L / med:.0f} frames/s; losses first {float(logs[0]['loss']):.4f} "
        f"last {float(logs[-1]['loss']):.4f}")
    windows, top = _trace_steps(step, (batch,), "s2s train")
    return {"model": model, "launches": launches, "step_ms": med * 1e3,
            "step_runs_ms": [t * 1e3 for t in times], "windows": windows,
            "top": [(n, t / 1e3, c) for n, t, c in top]}


@phase
def s2s_train_reference():
    """One step of the ListenerGenerator loss at S2S_B clips of ragged
    lengths (128-256) with ids, three times from the same weights: fp32 with
    the kernels, fp32 with the plain versions, and the plain versions in
    fp64 (``fp64_where_fp32``, the first run's VQ features and codes in
    place of the frozen VQs' encodes, as K4 takes fp32 only). Between the
    fp32 runs: equal VQ features and codes, losses within 1e-5 relative.
    Gradients, relative to each leaf's largest magnitude: on the non-VQ
    leaves the kernels within 1e-3 of the plain fp32 run; on every leaf the
    kernels' error against fp64 within 1e-3 or within 4x the plain fp32
    run's. The random speaker VQ gives most frames the same few codes, so
    the encoder's rows hardly differ and its query and key gradients are
    small differences of large sums: the test of a backward's rounding
    (``csrc/flash_attention.cu`` on its delta). K4's codes are held against
    the plain version on the latents it was given."""
    what = "the s2s training step"
    batch = _lg_batch(seed=42, lens=[L, 211, 170, 128], moving_speaker=True)
    state = _lg_model(seed=1).state_dict()
    runs, streams = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = _lg_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        src_v, tgt = (x.to(dtype) for x in batch[:2])
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(plain_attention() if plain else k4_calls())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
                x_sp, z_li = streams
                model._encode_streams = lambda *args: (x_sp.to(dtype), z_li)
            own = model._encode_streams(src_v, tgt, batch[2])
            streams = streams or own
            out = model(src_v, tgt, *batch[2:])
            out.loss.backward()
        if not plain:
            k4 = k4_on_path(calls, what)
        runs.append((float(out.loss.detach()), own, {k: p.grad.double() for k, p in
                                                     model.named_parameters()
                                                     if p.grad is not None}))
        del model
    (lk, sk, gk), (lp, sp, gp), (_, _, g64) = runs
    check(all(torch.equal(a, b) for a, b in zip(sk, sp)),
          "both fp32 runs' speaker VQ features and listener VQ codes equal")
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    check(rel <= 1e-5, f"fp32 s2s step B={S2S_B} ragged, kernels vs plain: loss {lk:.6f} vs "
          f"{lp:.6f}, rel err {rel:.3g} (tol 1e-5)")
    ek, ep, ekp = _grad_errs(gk, g64), _grad_errs(gp, g64), _grad_errs(gk, gp)
    core = [k for k in g64 if "_vq." not in k]
    worst = max(core, key=ekp.get)
    check(ekp[worst] <= 1e-3, f"gradients of the {len(core)} non-VQ leaves: kernels vs plain "
          f"within 1e-3 of each leaf's max, worst {ekp[worst]:.3g} ({worst})")
    lossy = sorted((k for k in g64 if ep[k] > 1e-4), key=ep.get, reverse=True)
    for k in lossy[:8]:
        say(f"  {k}: off fp64 by {ek[k]:.3g} (kernels) and {ep[k]:.3g} (plain fp32); "
            f"kernels vs plain {ekp[k]:.3g}")
    bad = [k for k in g64 if ek[k] > max(1e-3, 4 * ep[k])]
    check(not bad, f"s2s gradients against fp64: the kernels' error within 1e-3 or 4x the "
          f"plain fp32 run's on each of {len(g64)} leaves ({len(lossy)} leaves where the "
          f"plain fp32 run is past 1e-4; worst kernel error {max(ek.values()):.3g}, plain "
          f"fp32 {max(ep.values()):.3g}; failing: {bad[:5]})")
    return {"loss_rel": rel, "grad_rel": ekp[worst], "grad_rel_leaf": worst, "k4": k4,
            "kernels_vs_plain_all_leaves": max(ekp.values()),
            "kernels_vs_fp64": max(ek.values()), "plain_fp32_vs_fp64": max(ep.values()),
            "lossy_leaves": {k: {"kernels": ek[k], "plain_fp32": ep[k],
                                 "kernels_vs_plain": ekp[k]} for k in lossy}}


def _drive_twin(name, main, argv, runs):
    """``main(argv)`` with every launch count set to 0 just before and read
    just after; its exit code and what it printed."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = _stdout_of(main, argv)
    torch.cuda.synchronize()
    runs[name] = {"launches": dict(kernels.LAUNCHES), "s": time.perf_counter() - t0}
    say(f"{name}: exit {rc}, {runs[name]['s']:.1f} s, launches {runs[name]['launches']}")
    check(rc == 0, f"{name} ran to its end")
    return out


@phase
def s2s_generate_path(train):
    """The ``test_s2s`` loop (``cli.test_s2s.predict``) on the trained model of
    the s2s training step: S2S_B clips of L = 256, L - 1 codes sampled a
    clip, every launch count set to 0 just before and read just after (K1
    255 x 6 layers x (self, cross), K4 for the two VQ encodes), timed. Then
    one token sequence teacher-forced through ``decode_step`` in fp32 with
    the kernels and with the plain versions (logits within 1e-3). Then the
    twins on ViCo files that ``write_vico`` writes (S2S_RF_TRAIN train and
    S2S_RF_TEST test clips of L): ``cli.train_s2s.main`` (1 epoch), its
    ``--continuous`` branch (1 epoch), and ``cli.test_s2s.main`` from the
    first's checkpoint re-saved in the reference layout."""
    import shutil
    import tempfile

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import test_s2s, train_s2s
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_vico
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    model = train["model"].eval()
    batch = _lg_batch(seed=43)[:3]
    gen = torch.Generator(device="cuda").manual_seed(1)
    runs_ms, launches = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        y_true, y_pred, _ = test_s2s.predict(model, [batch], gen)
        torch.cuda.synchronize()
        runs_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launches or dict(kernels.LAUNCHES)
    say(f"launches of one test_s2s batch: {launches}")
    check(launches == S2S_GEN_LAUNCHES, f"test_s2s batch launches == {S2S_GEN_LAUNCHES} "
          "(K1 self and cross in 6 decoder layers x 255 codes, K2 in the 6 encoder layers, "
          "K4 twice)")
    check(len(y_pred) == S2S_B and all(p.shape == (L - 1, 56) and bool(
        torch.isfinite(torch.as_tensor(p)).all()) for p in y_pred),
          f"test_s2s: {len(y_pred)} predictions of ({L - 1}, 56), all finite")
    med = statistics.median(runs_ms)
    say(f"s2s generate, {S2S_B} clips x L={L} fp32, {CARD[-1]}: median {med:.1f} ms of "
        f"{[round(t, 1) for t in runs_ms]} -> {S2S_B * (L - 1) / med * 1e3:.0f} frames/s")

    with torch.no_grad():
        enc, prompt = model.encode_context(*batch)
        dec = model.generator.decoder.net
        cross = dec.cross_kv(enc)
        g = torch.Generator(device="cuda").manual_seed(4)
        seq = torch.cat([prompt, torch.randint(0, 512, (S2S_B, L - 1), device="cuda",
                                               generator=g)], dim=1)
        caches = [init_decoder_cache(S2S_B, L, dec.depth, dec.heads, dec.dim_head,
                                     torch.float32, None, "cuda") for _ in range(2)]
        worst = 0.0
        for t in range(L):
            a = dec.decode_step(seq[:, t: t + 1], caches[0], t, cross, batch[2])
            with plain_attention():
                b = dec.decode_step(seq[:, t: t + 1], caches[1], t, cross, batch[2])
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"s2s teacher-forced decode_step fp32 B={S2S_B}, {L} steps: logits "
          f"max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    del train["model"], model
    torch.cuda.empty_cache()

    root, cwd = tempfile.mkdtemp(prefix="s2s_files_"), os.getcwd()
    runs = {}
    try:
        write_vico(os.path.join(root, "data"), [L] * (S2S_RF_TEST + S2S_RF_TRAIN),
                   ["test"] * S2S_RF_TEST + ["train"] * S2S_RF_TRAIN, seed=44)
        os.makedirs(os.path.join(root, "work"))
        os.chdir(os.path.join(root, "work"))
        out = _drive_twin("train_s2s", train_s2s.main,
                          ["--save-path", os.path.join(root, "lg"), "epochs", "1"], runs)
        check("perplexity" in out, "train_s2s printed its validation perplexity")
        run_record(os.path.join(root, "lg"), "train_s2s")
        steps = S2S_RF_TRAIN // S2S_B
        want = {"decode_attention": 0, "flash_attention_fwd": 12 * (steps + 2),
                "flash_attention_bwd": 12 * steps, "nearest_code": 2 * steps + 2 * 2}
        check(runs["train_s2s"]["launches"] == want, f"train_s2s launches == {want}: {steps} "
              "steps (12 K2, 12 K3, 2 K4), then one validation batch through the model and "
              "the generator again (12 K2 and 2 K4 each)")
        _drive_twin("train_s2s_continuous", train_s2s.main,
                    ["--continuous", "--save-path", os.path.join(root, "cont"), "epochs", "1"],
                    runs)
        got = runs["train_s2s_continuous"]["launches"]
        check(got["flash_attention_fwd"] > 0 and got["flash_attention_bwd"] > 0
              and got["decode_attention"] == got["nearest_code"] == 0,
              f"train_s2s --continuous launched K2 and K3 only: {got}")
        run_record(os.path.join(root, "cont"), "train_s2s_continuous")
        ckpt = _reference_checkpoint(os.path.join(root, "lg", "best_model.pt"),
                                     os.path.join(root, "lg.pth.tar"))
        out = _drive_twin("test_s2s", test_s2s.main, ["--checkpoint", ckpt], runs)
        check(runs["test_s2s"]["launches"] == S2S_GEN_LAUNCHES and "fid_pose" in out,
              f"test_s2s on the reference-layout checkpoint: one batch of {S2S_RF_TEST} clips, "
              f"launches {S2S_GEN_LAUNCHES}, the battery printed")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "generate_ms": med, "generate_runs_ms": runs_ms,
            "teacher_forced_err": worst, "twins": runs}


STREAM_B, STREAM_CHUNK, STREAM_ROUNDS = 4, 8, 31
STREAM_K1_PER_TOKEN = 2 * 4  # self and cross in slm_defaults' 4 decoder layers


def _stream_clip(n, seed):
    """n synthetic CANDOR-shaped clips of L frames (moving speakers) on the
    card: (speaker motion, listener motion, audio, mask)."""
    return _candor(n, seed)


def _first_divergence(a, b):
    differ = (a != b).any(dim=0).nonzero()
    return None if differ.numel() == 0 else int(differ[0])


@phase
def streaming_path():
    """``StreamingListenerSession`` on SLMFT at full width (slm_defaults +
    vq_listener_defaults), batch STREAM_B, chunk 8, max_frames 256. In bf16:
    one feed, ``start`` from ``tokenize_listener_frames`` (K4 once), then
    STREAM_ROUNDS rounds of 8 frames and 8 codes, with every launch count
    set to 0 just before and read just after (K1 8 times a code: self and
    cross in 4 layers), each round timed on the host clock, synchronized.
    In fp32: the fed context rows against the offline ``decoder_context``
    (1e-4); a session fed the whole clip, one code sequence teacher-forced
    through ``stream_decode_step`` with the kernels and with the plain
    versions (logits within 1e-3); the first code where greedy streaming and
    offline ``generate_tokens(greedy=True)`` differ, if they do."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import generate_tokens
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingListenerSession

    vs, vl, va, mask = _stream_clip(STREAM_B, seed=51)
    model = _model(torch.bfloat16, seed=2)[0].to("cuda", torch.bfloat16).eval()
    sess = StreamingListenerSession(model, batch=STREAM_B, chunk=STREAM_CHUNK, max_frames=L,
                                    seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    c = STREAM_CHUNK
    sess.feed(vs[:, :c], va[:, :c])
    with torch.no_grad():
        sess.start(model.tokenize_listener_frames(vl[:, :c])[:, :1])
    times = []
    for r in range(1, STREAM_ROUNDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.round(vs[:, r * c: (r + 1) * c], va[:, r * c: (r + 1) * c])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    n_tok = STREAM_ROUNDS * c
    want = {"decode_attention": STREAM_K1_PER_TOKEN * (1 + n_tok), "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "nearest_code": 1}
    say(f"launches of the streaming session (prompt + {n_tok} codes): {launches}")
    check(launches == want, f"streaming launches == {want} (K1 {STREAM_K1_PER_TOKEN} a code "
          "and for the prompt step, K4 once for the prompt, no K2/K3: the chunk extension "
          "is dense)")
    toks = sess.tokens()
    check(tuple(toks.shape) == (STREAM_B, n_tok) and bool(((toks >= 0) & (toks < 512)).all())
          and sess.frames_fed == L, f"streamed codes {tuple(toks.shape)} in [0, 512), "
          f"{sess.frames_fed} frames fed")
    med = statistics.median(times)
    say(f"streaming round (feed {c} frames + {c} codes) B={STREAM_B} bf16, {CARD[-1]}: median "
        f"{med * 1e3:.2f} ms of {STREAM_ROUNDS} -> {STREAM_B * c / med:.0f} codes/s")
    del sess, model
    torch.cuda.empty_cache()

    model = _model(torch.float32, seed=2)[0].to("cuda").eval()
    sessions = [StreamingListenerSession(model, batch=STREAM_B, chunk=c, max_frames=L,
                                         greedy=True) for _ in range(2)]
    rows = torch.cat([sessions[0].feed(vs[:, t: t + c], va[:, t: t + c])
                      for t in range(0, L, c)], dim=1)
    for t in range(0, L, c):
        sessions[1].feed(vs[:, t: t + c], va[:, t: t + c])
    with torch.no_grad():
        ctx, prompt = model.encode_context(vs, vl, va, mask)
        ctx_err = float((rows - ctx).abs().max())
        offline = generate_tokens(model.decoder, prompt, L - 1, ctx, mask, greedy=True)
    check(ctx_err <= 1e-4, f"fp32 session context rows (32 feeds) vs offline decoder_context: "
          f"max abs err {ctx_err:.3g} (tol 1e-4)")
    g = torch.Generator(device="cuda").manual_seed(5)
    seq = torch.cat([prompt, torch.randint(0, 512, (STREAM_B, L - 1), device="cuda",
                                           generator=g)], dim=1)
    worst = 0.0
    with torch.no_grad():
        for t in range(L):
            a = model.stream_decode_step(seq[:, t: t + 1], sessions[0]._dec, t,
                                         sessions[0]._cross, sessions[0]._ctx_mask())
            with plain_attention():
                b = model.stream_decode_step(seq[:, t: t + 1], sessions[1]._dec, t,
                                             sessions[1]._cross, sessions[1]._ctx_mask())
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"fp32 session fed the clip, {L} teacher-forced stream_decode_steps: "
          f"logits max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    greedy = StreamingListenerSession(model, batch=STREAM_B, chunk=c, max_frames=L, greedy=True)
    for t in range(0, L, c):
        greedy.feed(vs[:, t: t + c], va[:, t: t + c])
    greedy.start(prompt)
    streamed = greedy.generate(L - 1)
    first = _first_divergence(streamed, offline)
    agree = float((streamed == offline).float().mean())
    say(f"fp32 greedy streaming vs offline generate_tokens: {agree:.4f} of codes equal, first "
        f"divergence at code {first} (exactness is held on the CPU, against JAX)")
    return {"launches": launches, "round_ms": med * 1e3, "round_runs_ms": [t * 1e3 for t in times],
            "codes_per_s": STREAM_B * c / med, "ctx_err": ctx_err, "teacher_forced_err": worst,
            "greedy_first_divergence": first, "greedy_agreement": agree}


POOL_P, POOL_ROUNDS, POOL_LEAVE = 8, 24, (2, 12)


def _pool_schedule(pool, clips, model, rounds, on_round=None):
    """Streams join one a round (slot s's stream at round s) until the pool
    is full, each fed its first chunk and started from the code of its first
    listener frame (``tokenize_listener_frames``, K4); every started slot
    then does a ``round`` (8 frames, 8 codes) each round. At round
    POOL_LEAVE[1] the stream of slot POOL_LEAVE[0] leaves and a new one (the
    clips' last) takes its slot. ``clips``: (speaker, audio, listener).
    Returns {slot: stream index}."""
    c = pool.chunk
    owner, pos = {}, {}
    for r in range(rounds):
        if r == POOL_LEAVE[1]:
            pool.leave(POOL_LEAVE[0])
            owner.pop(POOL_LEAVE[0])
        started = sorted(owner)
        if started:
            sp = torch.stack([clips[0][owner[s], pos[s]: pos[s] + c] for s in started])
            au = torch.stack([clips[1][owner[s], pos[s]: pos[s] + c] for s in started])
            pool.round(started, sp, au)
            for s in started:
                pos[s] += c
        stream = r if r < pool.capacity else (len(clips[0]) - 1 if r == POOL_LEAVE[1] else None)
        if stream is not None:
            s = pool.join(seed=100 + stream)
            owner[s], pos[s] = stream, c
            pool.feed([s], clips[0][stream:stream + 1, :c], clips[1][stream:stream + 1, :c])
            with torch.no_grad():
                prompt = model.tokenize_listener_frames(clips[2][stream:stream + 1, :c])
            pool.start([s], prompt[:, :1])
        if on_round is not None:
            on_round(r)
    return owner


@phase
def pool_path():
    """``StreamingSessionPool`` at capacity POOL_P on the same SLMFT: streams
    join at staggered rounds (one a round), then every slot does a round (8
    frames, 8 codes) each round; one stream leaves and a new one takes its
    slot. In bf16: the rounds at full occupancy timed (host clock,
    synchronized) for codes/s; K1's launches in one ``generate`` of n codes
    at partial and at full occupancy, n x 8 at both (one launch a layer and
    step serves every slot, each slot's bound a key mask). In fp32 and
    greedy: each slot's logits against a solo session's over the same
    stream, while their codes agree (1e-4), and the code agreement."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.serving import (
        StreamingListenerSession, StreamingSessionPool)

    n_streams = POOL_P + 1
    vs, vl, va, _ = _stream_clip(n_streams, seed=61)
    c = STREAM_CHUNK
    model = _model(torch.bfloat16, seed=3)[0].to("cuda", torch.bfloat16).eval()
    pool = StreamingSessionPool(model, capacity=POOL_P, chunk=c, max_frames=L)
    times, k1 = [], {}

    def per_generate(tag, slots):
        before = dict(kernels.LAUNCHES)
        pool.generate(slots, 4)
        torch.cuda.synchronize()
        k1[tag] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}

    def on_round(r):
        if r == 3:
            per_generate("3 slots", [0, 1, 2])
        if r == POOL_P:
            per_generate(f"{POOL_P} slots", list(range(POOL_P)))

    def timed(r):
        on_round(r)
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times.append(time.perf_counter())
    _pool_schedule(pool, (vs, va, vl), model, POOL_ROUNDS, timed)
    launches = dict(kernels.LAUNCHES)
    full = [b - a for a, b in zip(times[POOL_LEAVE[1] + 2:], times[POOL_LEAVE[1] + 3:])]
    say(f"launches of the pool's {POOL_ROUNDS} rounds: {launches}; of one generate of 4 "
        f"codes: {k1}")
    check(launches["nearest_code"] == n_streams and launches["flash_attention_fwd"] == 0
          and launches["decode_attention"] > 0, f"pool: K4 once a join ({n_streams}), K1 on "
          "every step, no K2/K3")
    want = {"decode_attention": 4 * STREAM_K1_PER_TOKEN, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "nearest_code": 0}
    check(all(v == want for v in k1.values()),
          f"one generate of n codes launches K1 n x {STREAM_K1_PER_TOKEN} whatever the "
          f"occupancy: {k1}")
    lens = [pool.tokens_generated(s) for s in range(POOL_P)]
    check(all(bool(((pool.tokens(s) >= 0) & (pool.tokens(s) < 512)).all())
              for s in range(POOL_P)), f"pool codes in [0, 512); codes a slot {lens}")
    med = statistics.median(full)
    say(f"pool round at full occupancy ({POOL_P} slots x {c} frames + {c} codes) bf16, "
        f"{CARD[-1]}: median {med * 1e3:.2f} ms of {len(full)} -> "
        f"{POOL_P * c / med:.0f} codes/s")
    del pool, model
    torch.cuda.empty_cache()

    model = _model(torch.float32, seed=3)[0].to("cuda").eval()
    rounds = 12
    pool = StreamingSessionPool(model, capacity=POOL_P, chunk=c, max_frames=L, greedy=True)
    solos = {}
    worst, compared = 0.0, 0

    def compare(r):
        nonlocal worst, compared
        for s, sess in solos.items():
            if pool.tokens(s).numel() and torch.equal(pool.tokens(s), sess.tokens()[0]):
                worst = max(worst, float((pool._logits[s] - sess._logits[0]).abs().max()))
                compared += 1

    class Shadow:
        """Drives a solo session for every pool slot alongside the pool."""

        def __init__(self, inner):
            self.inner, self.capacity, self.chunk = inner, inner.capacity, inner.chunk

        def join(self, seed):
            s = self.inner.join(seed)
            solos[s] = StreamingListenerSession(model, batch=1, chunk=c, max_frames=L,
                                                greedy=True)
            return s

        def leave(self, s):
            self.inner.leave(s)
            solos.pop(s)

        def feed(self, slots, sp, au):
            self.inner.feed(slots, sp, au)
            solos[slots[0]].feed(sp, au)

        def start(self, slots, prompt):
            self.inner.start(slots, prompt)
            solos[slots[0]].start(prompt)

        def round(self, slots, sp, au):
            self.inner.round(slots, sp, au)
            for i, s in enumerate(slots):
                solos[s].round(sp[i: i + 1], au[i: i + 1])

    _pool_schedule(Shadow(pool), (vs, va, vl), model, rounds, compare)
    agree = [float((pool.tokens(s) == sess.tokens()[0]).float().mean())
             for s, sess in solos.items()]
    check(compared > 0 and worst <= 1e-4, f"fp32 pool slots vs solo sessions over the same "
          f"streams: logits max abs err {worst:.3g} over {compared} comparisons (tol 1e-4)")
    say(f"fp32 greedy code agreement, pool slot vs solo session: "
        f"{[round(a, 4) for a in agree]}")
    return {"launches": launches, "k1_per_generate_4": k1, "round_ms": med * 1e3,
            "round_runs_ms": [t * 1e3 for t in full], "codes_per_s": POOL_P * c / med,
            "logits_err": worst, "compared": compared, "greedy_agreement": agree}


@phase
def speaker_streaming_path():
    """``StreamingSpeakerSession`` at the BIWI width of the speaker phases,
    fp32, one session fed a whole clip of BIWI_L frames (chunk 8), started
    from the clip's prompt and generating BIWI_L - 1 codes greedily, with
    every launch count set to 0 just before and read just after, against
    ``make_speaker_generator`` greedy on the clip: the first code where they
    differ, if they do; ``mesh`` within 1e-4 of the offline decode of the
    same codes."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_speaker_generator
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingSpeakerSession

    model = _speaker_model(seed=0).to("cuda").eval()
    clip = tuple(x[:1] for x in _biwi_batch(1, seed=71))
    verts, emoca, audio, mask, template, sids = clip
    with torch.no_grad():
        offline = make_speaker_generator(model)(clip, None, 1, greedy=True,
                                                return_tokens=True)[1]
        prompt = model.encode_context(*clip)[1]
    c = STREAM_CHUNK
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess = StreamingSpeakerSession(model, chunk=c, max_frames=BIWI_L, speaker_ids=sids,
                                   greedy=True)
    for t in range(0, BIWI_L, c):
        sess.feed(audio[:, t: t + c])
    sess.start(prompt)
    toks = sess.generate(BIWI_L - 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    say(f"launches of the speaker session ({BIWI_L - 1} codes): {launches}; {secs * 1e3:.1f} "
        f"ms fp32, {CARD[-1]}")
    check(launches["decode_attention"] == STREAM_K1_PER_TOKEN * BIWI_L
          and launches["nearest_code"] == 0,
          f"speaker session launches K1 {STREAM_K1_PER_TOKEN} a code (and the prompt step), "
          f"no K4: {launches}")
    first = _first_divergence(toks, offline)
    say(f"fp32 greedy speaker session vs make_speaker_generator: first divergence at code "
        f"{first}, {float((toks == offline).float().mean()):.4f} of codes equal")
    mesh, emo = sess.mesh(template)
    with torch.no_grad():
        ref_mesh, ref_emo = model.decode_emoca(toks, from_logits=False)
    err = max(float((mesh - ref_mesh - template[:, None]).abs().max()),
              float((emo - ref_emo).abs().max()))
    check(tuple(mesh.shape) == (1, BIWI_L - 1, BIWI_VDIM) and err <= 1e-4,
          f"speaker session mesh {tuple(mesh.shape)} within 1e-4 of the offline decode of the "
          f"same codes: {err:.3g}")
    return {"launches": launches, "ms": secs * 1e3, "greedy_first_divergence": first,
            "mesh_err": err}


# --- the speech path (wav2vec2 / HuBERT trunk, CodeTalker) at full width ---

SPEECH_SAMPLES, SPEECH_CLIPS = 77200, 4  # 241 conv frames: BIWI_L frames after the trim
CT_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                    "nearest_code": 2}


def _speech_audio(n, seed):
    """n waveforms of SPEECH_SAMPLES (4.825 s at 16 kHz), on the CPU."""
    return torch.randn(n, SPEECH_SAMPLES, generator=torch.Generator().manual_seed(seed))


@phase
def speech_trunk_path():
    """The wav2vec2-base trunk (7 conv layers of 512, 12 layers of 768 with 12
    heads, FF 3072), seeded random weights, fp32, over SPEECH_CLIPS BIWI-length
    waveforms: (4, 2 * BIWI_L, 768) features on the card within 1e-4 of the
    CPU's largest magnitude on the same weights; the median ms of one clip
    (CUDA events, 10 calls)."""
    from dyadic_interaction_modeling_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    torch.manual_seed(0)
    model = Wav2Vec2Model().eval()
    audio = _speech_audio(SPEECH_CLIPS, seed=31)
    with torch.no_grad():
        ref = model(audio, "BIWI", frame_num=BIWI_L)
        model = model.to("cuda")
        a = audio.to("cuda")
        out = model(a, "BIWI", frame_num=BIWI_L).cpu()
        err = float((out - ref).abs().max() / ref.abs().max())
        check(tuple(out.shape) == (SPEECH_CLIPS, 2 * BIWI_L, 768) and err <= 1e-4,
              f"wav2vec2 trunk {tuple(out.shape)} on the card vs the CPU: {err:.3g} of the "
              "largest magnitude (tol 1e-4)")
        ms = cuda_ms(lambda i: model(a[i % SPEECH_CLIPS: i % SPEECH_CLIPS + 1], "BIWI",
                                     frame_num=BIWI_L), 10)
    say(f"wav2vec2 trunk, one clip of {SPEECH_SAMPLES} samples fp32, {CARD[-1]}: median "
        f"{ms:.2f} ms (CUDA events)")
    return {"rel_err": err, "ms_per_clip": ms}


def _codetalker(seed):
    """CodeTalker at full width (codetalker_defaults: feature_dim 1024, 6
    decoder layers of 4 heads; the vertex VQ at 70110-d: hidden 384, 6 + 6
    layers, 512 x 128 codes; the wav2vec2-base trunk), fp32, seeded."""
    from dyadic_interaction_modeling_tpu_torch.config import codetalker_defaults
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CodeTalker

    torch.manual_seed(seed)
    return CodeTalker(codetalker_defaults())


def _ct_batch(seed):
    """One BIWI clip on the card: (1, SPEECH_SAMPLES) audio, (1, 70110)
    template, (1, BIWI_L, 70110) vertices, (1, 6) one-hot."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_biwi_dataset

    item = synthetic_biwi_dataset(n_clips=1, length=BIWI_L, n_vertices=BIWI_VDIM // 3,
                                  seed=seed)[0][0]
    one_hot = torch.zeros(1, 6)
    one_hot[0, seed % 6] = 1
    return tuple(torch.as_tensor(x).to("cuda") for x in (
        _speech_audio(1, seed), item["template"][None], item["vertice"][None], one_hot))


def _key_bias(name, n):
    """The slice of a key bias in the tensor ``name`` of length ``n`` (None
    if it holds none): its gradient is zero but for rounding, since it
    shifts every score of a row alike."""
    if name.endswith("k_proj.bias"):
        return slice(0, n)
    if name.endswith("in_proj_bias"):
        return slice(n // 3, 2 * n // 3)
    return None


def _ct_grads(state, batch, plain):
    """One CodeTalker loss from ``state`` with K4 or its plain version:
    (losses, trainable gradients but for their key biases, K4 calls)."""
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CODETALKER_FROZEN

    model = _codetalker(seed=0)
    model.load_state_dict(state)
    model = model.to("cuda")
    for k, p in model.named_parameters():
        p.requires_grad_(not k.startswith(CODETALKER_FROZEN))
    with k4_calls(plain=plain) as calls:
        total, (motion, reg) = model(*batch)
        total.backward()
    grads = {}
    for k, p in model.named_parameters():
        if p.grad is None:
            continue
        kb = _key_bias(k, len(p))
        if kb is None:
            grads[k] = p.grad.double()
        elif kb.start > 0:
            grads[k] = torch.cat([p.grad[: kb.start], p.grad[kb.stop:]]).double()
    logs = {k: float(v.detach()) for k, v in (("loss", total), ("motion", motion), ("reg", reg))}
    return logs, grads, calls


@phase
def codetalker_train_path():
    """The CodeTalker training step at full width, fp32, B = 1, L = BIWI_L,
    Adam 1e-4 (``train_stage2``'s step and frozen parts): 3 warmup steps,
    then 10 each between its own pair of CUDA events with every launch count
    set to 0 just before it and read just after (K4 2: the ground truth's
    encode and the prediction's quantize; no K1/K2/K3), frozen parameters
    bitwise unchanged and every trainable one the loss reaches moved, 3
    steps traced. Then, from the trained weights (``feat_map`` moved from
    its zero init), one loss with K4 and one with its plain version: equal
    codes, losses within 1e-5 relative, gradients within 1e-3 of each leaf's
    largest magnitude, and K4 on that step's latents (``k4_on_path``)."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli.train_stage2 import make_stage2_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CODETALKER_FROZEN

    model = _codetalker(seed=0).to("cuda").train()
    step = make_stage2_step(model, make_optimizer(model, 1e-4, 0.0, CODETALKER_FROZEN))
    batch = _ct_batch(seed=41)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    logs = [step(*batch) for _ in range(WARMUP_STEPS)]
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    per_step = []
    torch.cuda.synchronize()
    for start, end in pairs:
        kernels.reset_launch_counts()
        start.record()
        logs.append(step(*batch))
        end.record()
        per_step.append(dict(kernels.LAUNCHES))
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in pairs]
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    say(f"launches in each of {TRAIN_STEPS} CodeTalker steps: {per_step[0]}; in all: {launches}")
    check(all(s == CT_STEP_LAUNCHES for s in per_step),
          f"every CodeTalker step launches {CT_STEP_LAUNCHES}")
    check(all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values()),
          f"CodeTalker losses finite over {len(logs)} steps")
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(k.startswith(CODETALKER_FROZEN) for k in frozen)
          and all(torch.equal(model.get_parameter(k), before[k]) for k in frozen),
          f"{len(frozen)} frozen CodeTalker tensors (conv extractor, vertex VQ) bitwise "
          "unchanged")
    reached = [k for k, p in model.named_parameters() if p.grad is not None]
    still = []
    for k in reached:
        p, b, kb = model.get_parameter(k).detach(), before[k], _key_bias(k, before[k].numel())
        if kb is not None:  # left out: see _key_bias
            p, b = (torch.cat([x[: kb.start], x[kb.stop:]]) for x in (p, b))
        if p.numel() and torch.equal(p, b):
            still.append(k)
    check(len(reached) > 100 and not still, f"all {len(reached)} trainable tensors the loss "
          f"reaches moved, their key biases left out (unmoved: {still[:5]})")
    med = statistics.median(times)
    say(f"CodeTalker step B=1 L={BIWI_L} fp32, {CARD[-1]}, CUDA events: median {med:.2f} ms of "
        f"{[round(t, 2) for t in times]} -> {BIWI_L / med * 1e3:.0f} frames/s")
    say(f"losses of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, batch, "CodeTalker training")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, step
    torch.cuda.empty_cache()

    (lk, gk, ck), (lp, gp, cp) = (_ct_grads(state, batch, plain) for plain in (False, True))
    check(len(ck) == len(cp) == 2 and all(torch.equal(a[2], b[2]) for a, b in zip(ck, cp)),
          f"CodeTalker codes equal with K4 and with its plain version "
          f"({[int(c[2].numel()) for c in ck]} codes, "
          f"{len(torch.unique(ck[1][2]))} distinct in the prediction's)")
    k4 = k4_on_path(ck, "the CodeTalker training step")
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 CodeTalker losses, K4 vs plain: rel err "
          f"{max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-3, f"gradients of {len(errs)} trainable CodeTalker leaves within "
          f"1e-3 of each leaf's max, K4 vs plain: worst {errs[worst]:.3g} ({worst})")
    return {"launches": launches, "step_ms": med, "step_runs_ms": times, "windows": windows,
            "top": [(n, t / 1e3, c) for n, t, c in top], "losses_first": _rounded(logs[0]),
            "losses_last": _rounded(logs[-1]), "loss_rel": max(rel.values()),
            "grad_rel": errs[worst], "grad_rel_leaf": worst, "k4": k4, "state": state}


@phase
def codetalker_predict_path(train):
    """``CodeTalker.predict`` on one clip of BIWI_L frames from the trained
    weights, with every launch count set to 0 just before and read just
    after (K4 once a frame: BIWI_L, no K1/K2/K3): every frame's codes equal
    to those of a run on the plain version and its motion within 1e-4 of
    that run's largest magnitude, K4 on its own latents; then the median ms of 3 calls (host
    clock, synchronized), and K4 alone at the last frame's (120, 128) x
    (512, 128)."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code, nearest_code_plain

    model = _codetalker(seed=0)
    model.load_state_dict(train["state"])
    model = model.to("cuda").eval()
    audio, template, _, one_hot = _ct_batch(seed=43)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with k4_calls() as calls:
        motion = model.predict(audio, template, one_hot)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    say(f"launches of a CodeTalker predict of {BIWI_L} frames: {launches}")
    check(launches == {**CT_STEP_LAUNCHES, "nearest_code": BIWI_L},
          f"CodeTalker predict launches K4 once a frame ({BIWI_L}), no K1/K2/K3")
    k4 = k4_on_path(calls, "CodeTalker predict")
    with k4_calls(plain=True) as plain_calls:
        ref = model.predict(audio, template, one_hot)
    err = float((motion - ref).abs().max() / ref.abs().max())
    same = len(calls) == len(plain_calls) and all(
        torch.equal(a[2], b[2]) for a, b in zip(calls, plain_calls))
    check(same and tuple(motion.shape) == (1, BIWI_L, BIWI_VDIM) and err <= 1e-4,
          f"CodeTalker predict {tuple(motion.shape)}: every frame's codes equal to the plain "
          f"version's run ({len(torch.unique(calls[-1][2]))} distinct at the end), motion "
          f"within {err:.3g} of its largest magnitude (tol 1e-4)")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(audio, template, one_hot)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    say(f"CodeTalker predict, one clip of {BIWI_L} frames fp32, {CARD[-1]}: median {med:.1f} ms "
        f"of {[round(t, 1) for t in times]} -> {BIWI_L / med * 1e3:.0f} frames/s")
    z, e = calls[-1][0], calls[-1][1]
    k4_time = dict(ms=cuda_ms(lambda i: nearest_code(z, e), 200),
                   plain_ms=cuda_ms(lambda i: nearest_code_plain(z, e), 200), library_ms=None)
    n = z.shape[0]
    k4_time["bound_ms"], k4_time["bound_by"] = bound_ms(n * 128 * 4 + 512 * 128 * 4 + n * 4,
                                                        2 * n * 512 * 128, torch.float32)
    say(f"K4 at ({n},128) x (512,128) fp32: kernel {k4_time['ms'] * 1e3:.2f} us, plain "
        f"{k4_time['plain_ms'] * 1e3:.2f} us, bound {k4_time['bound_ms'] * 1e3:.3f} us")
    return {"launches": launches, "ms": med, "runs_ms": times, "motion_rel_err": err,
            "k4": k4, "k4_time": k4_time}


SPEECH_TRAIN_CLIPS = [("F2", 1), ("M3", 2)]
SPEECH_TEST_CLIPS = [("F1", 37), ("M1", 38)]


@phase
def speech_files_path():
    """The two speech CLIs' ``main()`` on a ``write_biwi`` tree in a temporary
    directory (23,370 vertices, BIWI_L frames and SPEECH_SAMPLES samples a
    clip): ``train_stage2`` for 2 epochs on the training split's 2 clips
    (K4 2 a step: 8), then ``test_biwi --data-root`` on the test split's 2
    clips with the port's HuBERT extractor on the card (K2 4 and K4 2 a
    clip) and the mouth and upper-face maps, twice: bitwise-equal
    predictions. The extractor on the card against the CPU's on the same
    weights: within 1e-4 of the largest magnitude."""
    import shutil
    import tempfile

    import numpy as np

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import test_biwi, train_stage2
    from dyadic_interaction_modeling_tpu_torch.data.datasets import load_wav_16k
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_biwi
    from dyadic_interaction_modeling_tpu_torch.models.hubert import make_hubert_extractor

    root = tempfile.mkdtemp(prefix="speech_files_")
    try:
        data = os.path.join(root, "BIWI")
        write_biwi(data, SPEECH_TRAIN_CLIPS + SPEECH_TEST_CLIPS, n_frames=BIWI_L,
                   n_vertices=BIWI_VDIM // 3, wav_samples=SPEECH_SAMPLES)
        runs = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = _stdout_of(train_stage2.main, ["--data-root", data, "--epochs", "2",
                                                 "--save-path", os.path.join(root, "stage2")])
        torch.cuda.synchronize()
        runs["train_stage2"] = {"launches": dict(kernels.LAUNCHES),
                                "s": time.perf_counter() - t0}
        losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines()
                  if "(motion" in line]
        want = {**CT_STEP_LAUNCHES, "nearest_code": 2 * 2 * len(SPEECH_TRAIN_CLIPS)}
        check(rc == 0 and runs["train_stage2"]["launches"] == want and len(losses) == 2
              and all(x == x and abs(x) != float("inf") for x in losses),
              f"train_stage2 on BIWI files: exit {rc}, launches "
              f"{runs['train_stage2']['launches']} (want {want}), epoch losses {losses}")
        regions = []
        for name, idx in (("lve.txt", BIWI_MOUTH), ("fdd.txt", range(BIWI_VDIM // 6,
                                                                     BIWI_VDIM // 3))):
            regions.append(os.path.join(root, name))
            with open(regions[-1], "w") as f:
                f.write(", ".join(str(i) for i in idx))
        argv = ["--data-root", data, "--vertice-dim", str(BIWI_VDIM), "--mouth-map", regions[0],
                "--upper-map", regions[1]]
        preds = []
        for run in ("a", "b"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc, out = _stdout_of(test_biwi.main, argv + ["--out-dir", os.path.join(root, run)])
            torch.cuda.synchronize()
            if run == "a":
                runs["test_biwi_data_root"] = {"launches": dict(kernels.LAUNCHES),
                                               "s": time.perf_counter() - t0}
                lve, fdd = (float(x) for x in out.split("LVE ")[1].split()[::2][:2])
            files = sorted(os.listdir(os.path.join(root, run, "pred")))
            preds.append({f: np.load(os.path.join(root, run, "pred", f)) for f in files})
        n = len(SPEECH_TEST_CLIPS)
        want = {"decode_attention": 0, "flash_attention_fwd": 4 * n, "flash_attention_bwd": 0,
                "nearest_code": 2 * n}
        check(rc == 0 and runs["test_biwi_data_root"]["launches"] == want,
              f"test_biwi --data-root: exit {rc}, launches "
              f"{runs['test_biwi_data_root']['launches']} (want {want}: a clip K2 4, K4 2)")
        check(len(preds[0]) == n and all(p.shape == (BIWI_L - 1, 56) for p in preds[0].values())
              and all(v == v and abs(v) != float("inf") for v in (lve, fdd)),
              f"test_biwi --data-root wrote {len(preds[0])} predictions of ({BIWI_L - 1}, 56); "
              f"LVE {lve:.6e} FDD {fdd:.6e}")
        check(preds[0].keys() == preds[1].keys()
              and all(np.array_equal(preds[0][f], preds[1][f]) for f in preds[0]),
              "two test_biwi --data-root runs give bitwise-equal predictions")
        wav = load_wav_16k(os.path.join(data, "wav", "F1_37.wav"))
        on_card = make_hubert_extractor(device="cuda")[0](wav)
        on_cpu = make_hubert_extractor(device="cpu")[0](wav)
        err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
        check(on_card.shape == (2 * BIWI_L + 1, 768) and err <= 1e-4,
              f"HuBERT extractor {on_card.shape} on the card vs the CPU: {err:.3g} of the "
              "largest magnitude (tol 1e-4)")
        return {"runs": runs, "losses": losses, "lve": lve, "fdd": fdd, "extractor_rel": err}
    finally:
        shutil.rmtree(root, ignore_errors=True)


@phase
def audio_frontend_path():
    """``StreamingAudioFrontend`` on the HuBERT-base trunk on the card, fp32:
    batch 4, fps 30, chunk 8, window 60, lookahead 2, over 4 s of audio pushed
    in irregular pieces, against one whole push: bitwise-equal emissions.
    Then the median ms of a push that completes one chunk (host clock,
    synchronized)."""
    from dyadic_interaction_modeling_tpu_torch.models.hubert import HubertModel
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingAudioFrontend

    torch.manual_seed(0)
    model = HubertModel().to("cuda").eval()
    kw = dict(fps=30, chunk=8, window_frames=60, lookahead=2, batch=4)
    wave = torch.randn(4, 4 * 16000, generator=torch.Generator().manual_seed(51)).numpy()
    whole = StreamingAudioFrontend(model, **kw).push(wave)
    fe, outs, at = StreamingAudioFrontend(model, **kw), [], 0
    for n in itertools.cycle((1601, 37, 5000, 12345, 999)):
        got = fe.push(wave[:, at: at + n])
        if got is not None:
            outs.append(got)
        at += n
        if at >= wave.shape[1]:
            break
    pieces = torch.cat(outs, dim=1)
    diff = float((pieces - whole).abs().max()) if pieces.shape == whole.shape else None
    check(tuple(whole.shape) == (4, fe.frames_emitted, 768) and diff == 0.0,
          f"streaming audio front-end: {tuple(whole.shape)} emissions, irregular pushes vs one "
          f"push: max difference {diff} (bitwise equal wanted)")
    chunk = fe._boundary(8)  # about one chunk of samples a push
    g = torch.Generator().manual_seed(52)
    times = []
    while len(times) < 10:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fe.push(torch.randn(4, chunk, generator=g).numpy())
        torch.cuda.synchronize()
        if got is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    say(f"audio front-end, batch 4, a window of 60 frames: median {med:.2f} ms to emit a chunk "
        f"of 8 frames ({CARD[-1]}; host clock, synchronized)")
    return {"frames_emitted": int(whole.shape[1]), "max_diff": diff, "chunk_ms": med,
            "chunk_runs_ms": times}


# --- the PIRender inference path (no K1-K4 on it: convolutions, norms and one
# grid_sample, cuDNN's and ATen's kernels) ---

RENDER_B, RENDER_T, RENDER_RES, RENDER_RADIUS = 8, 120, 256, 13
RENDER_REPS = 10
# the mixed config (mapping and editing nets in bf16, the warp in fp32)
# against fp32 on the card: max abs on each output, and mean abs on the fake
# image (images in [-1, 1], flow in pixels of the H/4 grid)
RENDER_MIXED_BOUND = {"flow_field": 0.02, "warp_image": 0.02, "fake_image": 0.1}
RENDER_MIXED_MEAN_BOUND = 0.01
def _render_inputs():
    """A smooth 256 x 256 source (uint8, so a PNG of it is the same image)
    and RENDER_T EMOCA-shaped frames (pose 6 + exp 50), seeded."""
    import numpy as np

    g = torch.Generator().manual_seed(62)
    low = torch.rand(1, 3, 16, 16, generator=g) * 2 - 1
    src = torch.nn.functional.interpolate(low, size=(RENDER_RES, RENDER_RES), mode="bilinear",
                                          align_corners=False)
    src8 = ((src[0].permute(1, 2, 0).clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).numpy()
    rng = np.random.default_rng(63)
    coeffs = np.concatenate([rng.normal(0, 0.1, (RENDER_T, 6)),
                             rng.normal(0, 0.3, (RENDER_T, 50))], axis=1).astype(np.float32)
    return src8, coeffs


def _render_config(name, sd, dtype, warp_dtype, tf32, batch):
    """One config's batch of RENDER_B: median ms of RENDER_REPS between CUDA
    events, frames/s, peak memory, and PROFILED_STEPS batches traced."""
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator

    model = FaceGenerator(flame_coeff_nc=56, coeff_nc=73, dtype=dtype,
                          warp_dtype=warp_dtype).to("cuda").eval()
    model.load_state_dict(sd, strict=True)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        def fwd(*_):
            with torch.inference_mode():
                return model(*batch)

        out = {k: v.float() for k, v in fwd().items()}
        ms = cuda_ms(fwd, RENDER_REPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        windows, top = _trace_steps(fwd, (), f"render batch ({name})")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    say(f"render batch of {RENDER_B} at {RENDER_RES}x{RENDER_RES}, {name}, {CARD[-1]}: median "
        f"{ms:.2f} ms -> {RENDER_B / ms * 1e3:.1f} frames/s, peak {peak:.0f} MiB, card busy "
        f"{100 * windows['card']['busy_share']:.1f}% of 3 traced batches")
    return out, {"batch_ms": ms, "frames_per_s": RENDER_B / ms * 1e3, "peak_mib": peak,
                 "busy_share": windows["card"]["busy_share"], "traced_windows": windows,
                 "top_kernels": [{"name": n[:120], "ms": t / 1e3, "launches": c}
                                 for n, t, c in top[:8]]}


@phase
def render_path():
    """PIRender's FaceGenerator at full width (``RENDER_DEFAULTS``:
    descriptor 256, 3 mapping layers; warp base 32 to 256 over 5 + 3
    hourglass blocks; editing base 64, 3 layers, 2 res blocks; 56-d EMOCA
    coefficients into the 73-d ``pre`` conv), seeded random weights, a
    256 x 256 source and a clip of RENDER_T frames in windows of radius 13.
    ``render_clip`` with batch 8 in fp32 (TF32 off), twice (cold, then
    warm), with every launch count set to 0 just before each and read just
    after (K1-K4: none); its first batch
    against the same weights on the CPU (flow, warp and fake within 1e-3 of
    each output's largest magnitude); the mixed config (bf16 mapping and
    editing nets, fp32 warp) against the card's fp32 output within
    RENDER_MIXED_BOUND; then each of fp32 (TF32 off), fp32 with TF32 and the
    mixed config timed on one batch of 8 (median of 10 between CUDA events),
    its peak memory and 3 batches traced."""
    import numpy as np

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.render.data import semantic_window
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.inference import render_clip

    torch.manual_seed(61)
    model = FaceGenerator(flame_coeff_nc=56, coeff_nc=73).eval()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    src8, coeffs = _render_inputs()
    src = src8.astype(np.float32) / 127.5 - 1.0
    windows = torch.from_numpy(np.stack([semantic_window(coeffs, i, RENDER_RADIUS)
                                         for i in range(RENDER_B)]))
    img = torch.from_numpy(src).permute(2, 0, 1)[None].expand(RENDER_B, -1, -1, -1)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = model(img, windows)
    say(f"render batch of {RENDER_B} on the CPU (the reference): {time.perf_counter() - t0:.1f} s")
    model = model.to("cuda")
    batch = (img.to("cuda"), windows.to("cuda"))
    clip_s = []
    for _ in range(2):  # cold (cuDNN's first choices, the context), then warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clip = render_clip(model, src, coeffs, RENDER_RADIUS, batch_size=RENDER_B)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    check(all(v == 0 for v in launches.values()), f"render_clip of {RENDER_T} frames launched "
          f"no K1-K4: {launches}")
    check(clip["fake_image"].shape == (RENDER_T, RENDER_RES, RENDER_RES, 3)
          and bool(np.isfinite(clip["fake_image"]).all()),
          f"render_clip: {clip['fake_image'].shape[0]} finite frames of {RENDER_RES}^2")
    say(f"render_clip of {RENDER_T} frames, batch {RENDER_B}, fp32 (TF32 off), {CARD[-1]}: "
        f"{clip_s[0]:.2f} s cold, {clip_s[1]:.2f} s warm (host clock, numpy in and out) -> "
        f"{RENDER_T / clip_s[1]:.1f} frames/s")
    with torch.inference_mode():
        card = model(*batch)
    errs = {}
    for k in ("flow_field", "warp_image", "fake_image"):
        ref = cpu[k]
        errs[k] = float((card[k].cpu() - ref).abs().max() / ref.abs().max())
        check(errs[k] <= 1e-3, f"render batch {k} on the card vs the CPU: max abs err "
              f"{errs[k]:.3g} of its largest magnitude (tol 1e-3)")
    first = np.abs(clip["fake_image"][:RENDER_B] - cpu["fake_image"].permute(0, 2, 3, 1).numpy())
    check(float(first.max()) <= 1e-3, f"render_clip's first batch is the checked batch: fake "
          f"within {float(first.max()):.3g} of the CPU's")
    del model, card
    results = {}
    fp32_out, results["fp32"] = _render_config("fp32, TF32 off", sd, torch.float32, None,
                                               False, batch)
    _, results["fp32_tf32"] = _render_config("fp32, TF32 on", sd, torch.float32, None, True,
                                             batch)
    mixed_out, results["mixed"] = _render_config("bf16 editing, fp32 warp", sd, torch.bfloat16,
                                                 torch.float32, False, batch)
    mixed = {}
    for k, bound in RENDER_MIXED_BOUND.items():
        d = (mixed_out[k] - fp32_out[k]).abs()
        mixed[k] = {"max_abs": float(d.max()), "mean_abs": float(d.mean())}
        ok = mixed[k]["max_abs"] <= bound and (k != "fake_image"
                                               or mixed[k]["mean_abs"] <= RENDER_MIXED_MEAN_BOUND)
        check(ok, f"render mixed config vs fp32 on the card, {k}: max abs {mixed[k]['max_abs']:.3g}"
              f" (bound {bound}), mean abs {mixed[k]['mean_abs']:.3g}"
              + (f" (bound {RENDER_MIXED_MEAN_BOUND})" if k == "fake_image" else ""))
    return {"launches": launches, "cpu_rel_err": errs, "mixed_vs_fp32": mixed,
            "clip_s": clip_s, "clip_frames_per_s": RENDER_T / clip_s[1], **results,
            "state_dict": sd, "source": src8, "coeffs": coeffs}


def _same_png(path, want_uint8):
    """Largest uint8 difference between the PNG at ``path`` and ``want``."""
    import numpy as np

    from dyadic_interaction_modeling_tpu_torch.render.image_io import read_png

    return int(np.abs(read_png(path).astype(int) - want_uint8.astype(int)).max())


@phase
def render_files_path(render):
    """The render twins on the card at ``--resolution 256`` through
    ``--checkpoint``, each with every launch count set to 0 just before and
    read just after (K1-K4: none): ``render_inference`` on a coefficient
    directory of 16 of ``render_path``'s frames from its source written as a
    PNG, with ``render_path``'s weights as a reference-layout ``.pt``
    (``{"net_G_ema": sd}``); ``render_inference --video`` on a
    ``write_vox_lmdb(..., img_format="png")`` root of two persons' clips of
    16 frames, with a generator for the LMDB's 73-d windows (cv2 hidden, so
    it writes gt | warp | fake PNG frames, not an mp4); and
    ``intuitive_control --synthetic`` (120 frames of batch 1). Frame counts,
    and frames against the same weights rendered in memory (one uint8
    level)."""
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import intuitive_control, render_inference
    from dyadic_interaction_modeling_tpu_torch.render.data import (
        VoxVideoDataset, emoca_to_coeff3dmm, write_vox_lmdb)
    from dyadic_interaction_modeling_tpu_torch.render.generator import (
        FaceGenerator, face_generator_from_state_dict)
    from dyadic_interaction_modeling_tpu_torch.render.image_io import write_png
    from dyadic_interaction_modeling_tpu_torch.render.inference import (
        render_clip, render_windows, to_uint8_frame, to_uint8_video)

    root, runs, n = tempfile.mkdtemp(prefix="render_files_"), {}, 16

    def drive(name, main, argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        runs[name] = {"launches": dict(kernels.LAUNCHES), "s": time.perf_counter() - t0}
        say(f"{name}: {runs[name]['s']:.1f} s, launches {runs[name]['launches']}")
        check(all(v == 0 for v in runs[name]["launches"].values()),
              f"{name} launched no K1-K4")
        return out

    try:
        ckpt = os.path.join(root, "pirender.pt")
        torch.save({"net_G_ema": render["state_dict"], "current_iteration": 0}, ckpt)
        src_png = os.path.join(root, "source.png")
        write_png(src_png, render["source"])
        clip_dir = os.path.join(root, "clip")
        for i, row in enumerate(render["coeffs"][:n]):
            os.makedirs(os.path.join(clip_dir, f"{i:06d}"))
            np.save(os.path.join(clip_dir, f"{i:06d}", "pose.npy"), row[:6])
            np.save(os.path.join(clip_dir, f"{i:06d}", "exp.npy"), row[6:])
        out_dir = os.path.join(root, "out")
        got = drive("render_inference", render_inference.main, [
            "--checkpoint", ckpt, "--source-image", src_png, "--coeff-dir", clip_dir,
            "--out", out_dir, "--resolution", str(RENDER_RES), "--device", "cuda"])
        counts = [len(os.listdir(os.path.join(out_dir, k))) for k in ("fake", "warp")]
        model = face_generator_from_state_dict(render["state_dict"]).to("cuda").eval()
        src = render["source"].astype(np.float32) / 127.5 - 1.0
        want = render_clip(model, src, render["coeffs"][:n], RENDER_RADIUS, RENDER_B)
        diff = _same_png(os.path.join(out_dir, "fake", "00005.png"),
                         to_uint8_frame(want["fake_image"][5]))
        check(counts == [n, n] and diff <= 1 and got["fake_image"].shape[0] == n,
              f"render_inference wrote {counts} fake/warp frames of {n}; frame 5 within {diff} "
              "uint8 levels of the same weights in memory (1 allowed)")

        torch.manual_seed(64)
        sd73 = FaceGenerator(flame_coeff_nc=73, coeff_nc=73).state_dict()
        ckpt73 = os.path.join(root, "pirender73.pt")
        torch.save({"net_G_ema": sd73}, ckpt73)
        rng = np.random.default_rng(65)
        clips = {}
        for person in ("id10001", "id10002"):
            drift = rng.normal(0, 0.05, (n, 1, 1, 3))
            frames = np.clip(src[None] + drift, -1, 1)
            emoca = np.concatenate([rng.normal(0, 0.1, (n, 6)), rng.normal(0, 0.3, (n, 50))], 1)
            clips[f"{person}#vid#00001"] = {"frames": frames, "coeff_3dmm": emoca_to_coeff3dmm(
                emoca, rng.normal(1.0, 0.1, (n, 3)))}
        vox = os.path.join(root, "vox")
        write_vox_lmdb(vox, clips, resolution=RENDER_RES, test_names=list(clips),
                       img_format="png")
        with mock.patch.dict(sys.modules, {"cv2": None}):  # the PNG frames, to compare
            written = drive("render_inference_video", render_inference.main, [
                "--video", "--vox-root", vox, "--checkpoint", ckpt73, "--out",
                os.path.join(root, "video"), "--resolution", str(RENDER_RES),
                "--device", "cuda"])
        ds = VoxVideoDataset(vox, resolution=RENDER_RES)
        data = ds.load_next_video()
        model73 = face_generator_from_state_dict(sd73).to("cuda").eval()
        want = render_windows(model73, data["source_image"], data["target_semantics"], RENDER_B)
        diff = _same_png(os.path.join(written[0], "00007.png"), np.concatenate(
            [to_uint8_video(data[k][7:8])[0] if k == "target_images"
             else to_uint8_video(want[k][7:8])[0]
             for k in ("target_images", "warp_image", "fake_image")], axis=1))
        n_written = len(os.listdir(written[0]))
        check(len(written) == 2 and n_written == n and diff <= 1,
              f"render_inference --video wrote {len(written)} videos of {n_written} frames; "
              f"frame 7 within {diff} uint8 levels of the same weights in memory (1 allowed)")

        ctrl = os.path.join(root, "control")
        frames = drive("intuitive_control", intuitive_control.main, [
            "--synthetic", "--checkpoint", ckpt, "--resolution", str(RENDER_RES),
            "--device", "cuda", "--out", ctrl])
        pngs = [f for f in os.listdir(ctrl) if not f.startswith("_")]
        check(frames == 120 and len(pngs) == 120, f"intuitive_control --synthetic wrote {frames} "
              f"frames ({len(pngs)} PNGs; 10 steps x 12 presets wanted)")
        return {"runs": runs}
    finally:
        shutil.rmtree(root, ignore_errors=True)


AVATAR_CHUNK, AVATAR_MAX, AVATAR_RADIUS, AVATAR_WINDOW = 8, 1024, 13, 10
AVATAR_ROUNDS = 24  # the equality stream's chunks, and the timed steady rounds
AVATAR_STREAM = 48  # chunks of speaker input made for a timed run
AVATAR_RENDER = dict(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=256, mapping_layers=3)
# launches of a steady round in either pipeline, written in PERF.md before the
# first run: K1 8 a code (self and cross in slm_defaults' 4 decoder layers) x
# 8 codes; K2 once in each of the listener VQ decoder's 6 layers, one masked
# decode of the 1024-token buffer (L >= FLASH_MIN_LEN under a key mask)
AVATAR_ROUND_LAUNCHES = {"decode_attention": 64, "flash_attention_fwd": 6,
                         "flash_attention_bwd": 0, "nearest_code": 0}
AVATAR_K2_ROUNDS = (3, 24, 128)  # the masked decode's lengths 8 k for K2's check


def _avatar_inputs():
    """``bench.py``'s low-frequency 256 x 256 source (1, H, W, 3) and
    AVATAR_STREAM chunks of speaker motion (1, T, 56) and audio (1, T, 768),
    seeded, numpy as a server receives them."""
    import numpy as np

    lin = np.linspace(0, 6.0, RENDER_RES)
    src = np.sin(lin[:, None, None] + 1.7 * lin[None, :, None] + np.arange(3)) * 0.7
    rng = np.random.default_rng(73)
    t = AVATAR_STREAM * AVATAR_CHUNK
    return (src[None].astype(np.float32), rng.standard_normal((1, t, 56), dtype=np.float32),
            rng.standard_normal((1, t, 768), dtype=np.float32))


def _avatar_pipes(model, renderer, src, *, uint8=True, lookahead=AVATAR_CHUNK, depth=1):
    """The two pipelines of ``bench.py``'s avatar shape (batch 1, chunk 8,
    1024 frames and tokens, window 10, radius 13, the fake image only), one
    session seed and the zero prompt: {"fused": ..., "composable": ...} as
    factories."""
    from dyadic_interaction_modeling_tpu_torch.serving import (
        FusedAvatarPipeline, StreamingAvatarPipeline, StreamingListenerSession)

    c = AVATAR_CHUNK

    def fused():
        return FusedAvatarPipeline(
            model, renderer=renderer, source_images=src, chunk=c, max_frames=AVATAR_MAX,
            max_tokens=AVATAR_MAX, seed=7, vq_lookahead=lookahead,
            smooth_window=AVATAR_WINDOW, semantic_radius=AVATAR_RADIUS, render_uint8=uint8,
            pipeline_depth=depth)

    def composable():
        sess = StreamingListenerSession(model, chunk=c, max_frames=AVATAR_MAX,
                                        max_tokens=AVATAR_MAX, seed=7)
        return StreamingAvatarPipeline(
            sess, vq_lookahead=lookahead, vq_granularity=c, smooth_window=AVATAR_WINDOW,
            semantic_radius=AVATAR_RADIUS, renderer=renderer, source_images=src,
            render_frames_per_call=c, render_outputs=("fake_image",), render_uint8=uint8,
            render_pipeline_depth=depth)

    return {"fused": fused, "composable": composable}


def _avatar_stream(pipe, sp, au, n):
    """n chunks pushed, then flush: (per-call outputs, codes, frames)."""
    import numpy as np

    c = AVATAR_CHUNK
    outs = [pipe.push(sp[:, i * c: (i + 1) * c], au[:, i * c: (i + 1) * c]) for i in range(n)]
    outs.append(pipe.flush())
    return (outs, np.concatenate([o["tokens"] for o in outs], axis=1),
            np.concatenate([o["fake_image"] for o in outs], axis=1))


def _avatar_k1_check(pipe, sp, au, i, tol, tag):
    """K1 at the avatar's own calls: the push of chunk i with every
    ``decode_attention`` call recorded (its inputs copied, since the caches
    change in place), then each call's inputs through the kernel and its
    plain version: the max abs error of all within tol."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    c, calls = AVATAR_CHUNK, []

    def record(q, k, v, t=None, key_mask=None, *, scale):
        calls.append((*(x.clone() if isinstance(x, torch.Tensor) else x
                        for x in (q, k, v, t, key_mask)), scale))
        return decode_attention(q, k, v, t, key_mask, scale=scale)

    with mock.patch.object(xtrans, "decode_attention", record):
        pipe.push(sp[:, i * c: (i + 1) * c], au[:, i * c: (i + 1) * c])
    worst, shapes = 0.0, set()
    for q, k, v, t, km, scale in calls:
        out = decode_attention(q, k, v, t, km, scale=scale)
        ref = decode_attention_plain(q, k, v, t, km, scale=scale)
        worst = max(worst, float((out.float() - ref.float()).abs().max()))
        shapes.add((tuple(q.shape), tuple(k.shape), "self" if km is None else
                    f"cross, mask {tuple(km.shape)}"))
    want = AVATAR_ROUND_LAUNCHES["decode_attention"]
    check(len(calls) == want and worst <= tol, f"K1 at the avatar's {len(calls)} calls of a "
          f"steady round ({want} wanted), {tag}, {sorted(shapes)}: kernel vs plain, max abs "
          f"err {worst:.3g} (tol {tol})")
    return {"calls": len(calls), "max_abs_err": worst, "shapes": sorted(map(str, shapes))}


def _avatar_timed(makes, sp, au, cfg):
    """Both pipelines of one config, built and filled one after the other;
    each one's steady round with every launch count set to 0 just before
    and read just after, and its peak memory (the models and its own state,
    the other's resident state taken out); then AVATAR_ROUNDS steady rounds
    of each, in turns (the host's pace drifts within a call), each push
    timed on the host clock as ``bench.py`` times it (no synchronization:
    with the download double-buffered a fused push waits only for the round
    before); then PROFILED_STEPS rounds of each traced."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    c, pipes, fed, res = AVATAR_CHUNK, {}, {}, {}

    def push(name):
        i = fed[name]
        fed[name] += 1
        return pipes[name].push(sp[:, i * c: (i + 1) * c], au[:, i * c: (i + 1) * c])

    torch.cuda.synchronize()
    models = torch.cuda.memory_allocated()
    for name, make in makes.items():
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipes[name], fed[name] = make(), 0
        while push(name)["fake_image"].shape[1] == 0:
            pass
        res[name] = {"first_frames_round": fed[name]}
        push(name)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        push(name)
        launches = dict(kernels.LAUNCHES)
        check(launches == AVATAR_ROUND_LAUNCHES, f"avatar {name} ({cfg} config): launches of "
              f"a steady round {launches} == {AVATAR_ROUND_LAUNCHES}")
        torch.cuda.synchronize()
        res[name].update(launches=launches, peak_mib=(torch.cuda.max_memory_allocated()
                                                      - (before - models)) / 2 ** 20)
    times = {name: [] for name in pipes}
    for r in range(AVATAR_ROUNDS):
        for name in (list(pipes) if r % 2 == 0 else list(pipes)[::-1]):
            t0 = time.perf_counter()
            push(name)
            times[name].append(time.perf_counter() - t0)
    for name in pipes:
        windows, top = _trace_steps(push, (name,), f"avatar {name} ({cfg} config) round")
        p50 = statistics.median(times[name])
        r = res[name]
        say(f"avatar {name} ({cfg} config), {CARD[-1]}: push p50 {p50 * 1e3:.2f} ms of "
            f"{AVATAR_ROUNDS} steady rounds (first frames on round {r['first_frames_round']}) "
            f"-> {c / p50:.1f} rendered frames/s, real-time (p50 <= {c / 30 * 1e3:.1f} ms): "
            f"{p50 <= c / 30}; peak {r['peak_mib']:.0f} MiB; card busy "
            f"{100 * windows['card']['busy_share']:.1f}% of {PROFILED_STEPS} traced rounds, "
            f"{windows['card']['kernels'] / PROFILED_STEPS:.0f} launches a round")
        r.update(round_ms_p50=p50 * 1e3, round_runs_ms=[t * 1e3 for t in times[name]],
                 frames_per_s=c / p50, realtime=p50 <= c / 30,
                 busy_share=windows["card"]["busy_share"], traced_windows=windows,
                 launches_a_round_traced=windows["card"]["kernels"] / PROFILED_STEPS,
                 top_kernels=[{"name": n[:120], "ms": t / 1e3, "launches": k}
                              for n, t, k in top[:8]])
    return res


@phase
def avatar_path():
    """The live avatar chain at ``bench.py``'s avatar shape (``bench.py:55,
    64-65, 429-445``): SLMFT at ``slm_defaults()`` + ``vq_listener_defaults()``
    and ``FaceGenerator`` at AVATAR_RENDER, seeded random weights, 256 x 256,
    batch 1, chunk 8, 1024 frames and tokens, lookahead 8, radius 13, window
    10, uint8 fake images, the download double-buffered. (1) fp32 (TF32
    off): ``FusedAvatarPipeline`` against ``StreamingAvatarPipeline``
    (granularity = chunk) on one seeded stream of AVATAR_ROUNDS chunks, one
    session seed: codes bitwise equal, float frames within 5e-5, uint8
    within one level, as many frames as fed, the fused pipeline's first
    frames on the round d_win + pipeline_depth + 1; (2) the composable
    pipeline with ``vq_lookahead=None`` against the offline chain on its
    codes (``decode_tokens_to_motion``, ``smooth_logits_matrix``,
    ``semantic_window`` a frame, ``render_windows``) within one uint8 level;
    (3) bf16: K2 at the masked decode's call ((8, 1024, 48), key mask of
    lengths 8 k) against its plain version (2e-2), timed with SDPA beside
    it; steady fused rounds with nothing waiting for the card (no
    synchronizing call under ``torch.cuda.set_sync_debug_mode``); K1 at the
    calls of a steady fused round (self and cross, caches of 1024, the
    (1, 1024) context mask) against its plain version, in fp32 (1e-5) and
    bf16 (2e-2); (4) each
    pipeline timed in the bench config (bf16 SLMFT, bf16 generator and warp)
    and the mixed one (fp32 warp), its launches a round against
    AVATAR_ROUND_LAUNCHES."""
    import warnings
    from unittest import mock

    import numpy as np
    import torch.nn.functional as F

    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from dyadic_interaction_modeling_tpu_torch.ops import transformer
    from dyadic_interaction_modeling_tpu_torch.postprocess import smooth_logits_matrix
    from dyadic_interaction_modeling_tpu_torch.render.data import semantic_window
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.inference import (
        render_windows, to_uint8_frame)
    from dyadic_interaction_modeling_tpu_torch.serving import (
        StreamingAvatarPipeline, StreamingListenerSession)

    c, n = AVATAR_CHUNK, AVATAR_ROUNDS
    src, sp, au = _avatar_inputs()
    torch.manual_seed(72)
    render_sd = FaceGenerator(**AVATAR_RENDER).state_dict()

    def renderer(dtype=torch.float32, warp_dtype=None):
        m = FaceGenerator(**AVATAR_RENDER, dtype=dtype, warp_dtype=warp_dtype)
        m.load_state_dict(render_sd, strict=True)
        return m.to("cuda").eval()

    res = {}
    model = _model(torch.float32, seed=71)[0].to("cuda").eval()
    r32 = renderer()
    eq = {}
    for uint8 in (False, True):
        pipes = _avatar_pipes(model, r32, src, uint8=uint8)
        fused = pipes["fused"]()
        f_outs, f_toks, f_frames = _avatar_stream(fused, sp, au, n)
        _, c_toks, c_frames = _avatar_stream(pipes["composable"](), sp, au, n)
        kind = "uint8" if uint8 else "float"
        check(np.array_equal(f_toks, c_toks) and f_toks.shape == (1, n * c),
              f"avatar fp32 {kind}: fused and composable codes bitwise equal "
              f"({f_toks.shape[1]} codes, {int((f_toks != c_toks).sum())} differ)")
        check(f_frames.shape == c_frames.shape == (1, n * c, RENDER_RES, RENDER_RES, 3),
              f"avatar fp32 {kind}: {f_frames.shape[1]} fused and {c_frames.shape[1]} "
              f"composable frames for {n * c} fed")
        err = float(np.abs(f_frames.astype(np.float64) - c_frames).max())
        tol = 1 if uint8 else 5e-5
        check(err <= tol, f"avatar fp32 {kind} frames, fused vs composable: max abs "
              f"{err:.3g} (tol {tol})")
        first = next(i for i, o in enumerate(f_outs) if o["fake_image"].shape[1])
        want = fused.d_win + fused.pipeline_depth
        check(first == want, f"avatar fp32 {kind}: the fused pipeline's first frames on round "
              f"{first + 1} (d_win {fused.d_win} + pipeline_depth {fused.pipeline_depth} + 1)")
        eq[kind] = {"max_abs": err, "codes": int(f_toks.shape[1]), "first_round": first + 1}
        del fused
    res["fused_vs_composable_fp32"] = eq

    sess = StreamingListenerSession(model, chunk=c, max_frames=AVATAR_MAX,
                                    max_tokens=AVATAR_MAX, seed=7)
    live = StreamingAvatarPipeline(
        sess, vq_lookahead=None, smooth_window=AVATAR_WINDOW, semantic_radius=AVATAR_RADIUS,
        renderer=r32, source_images=src, render_frames_per_call=c,
        render_outputs=("fake_image",), render_uint8=True)
    _, toks, frames = _avatar_stream(live, sp, au, n)
    t_total = toks.shape[1]
    with torch.no_grad():
        coeffs = model.decode_tokens_to_motion(
            torch.as_tensor(toks, device="cuda").long(),
            torch.full((1,), t_total, device="cuda")).float().cpu().numpy()[0]
    smoothed = smooth_logits_matrix(coeffs, AVATAR_WINDOW)
    windows = np.stack([semantic_window(smoothed, i, AVATAR_RADIUS) for i in range(t_total)])
    offline = to_uint8_frame(render_windows(r32, src[0], windows, batch_size=c)["fake_image"])
    live_err = int(np.abs(frames[0].astype(int) - offline.astype(int)).max())
    check(frames.shape[1] == t_total and live_err <= 1,
          f"avatar fp32, vq_lookahead=None: {frames.shape[1]} live frames against the offline "
          f"chain on its {t_total} codes, max {live_err} uint8 levels (tol 1)")
    res["live_vs_offline_uint8"] = live_err
    pipe = _avatar_pipes(model, r32, src)["fused"]()
    for i in range(3):
        pipe.push(sp[:, i * c: (i + 1) * c], au[:, i * c: (i + 1) * c])
    res["k1_fp32"] = _avatar_k1_check(pipe, sp, au, 3, 1e-5, "fp32")
    del model, r32, live, sess, pipe
    torch.cuda.empty_cache()

    model = _model(torch.bfloat16, seed=71)[0].to("cuda", torch.bfloat16).eval()
    calls, real = [], transformer.flash_attention

    def record(q, k, v, key_mask=None, **kw):
        calls.append((q, k, v, key_mask, kw))
        return real(q, k, v, key_mask, **kw)

    g = torch.Generator(device="cuda").manual_seed(74)
    buf = torch.randint(0, 512, (1, AVATAR_MAX), device="cuda", generator=g)
    k2 = {}
    for k_round in AVATAR_K2_ROUNDS:
        calls.clear()
        lengths = torch.full((1,), c * k_round, device="cuda")
        with mock.patch.object(transformer, "flash_attention", record), torch.no_grad():
            model.decode_tokens_to_motion(buf, lengths)
        worst, shapes = 0.0, set()
        for q, k, v, km, kw in calls:
            o, ro = flash_attention_fwd(q, k, v, km, **kw)[0], flash_attention_fwd_plain(
                q, k, v, km, **kw)[0]
            d = (o.float() - ro.float()).abs()
            worst = max(worst, float((d - 2e-2 * ro.float().abs()).max()))
            shapes.add((tuple(q.shape), str(q.dtype)[6:], None if km is None else
                        tuple(km.shape)))
        ok = len(calls) == 6 and shapes == {((8, AVATAR_MAX, 48), "bfloat16", (1, AVATAR_MAX))}
        check(ok and worst <= 2e-2, f"K2 at the masked decode's {len(calls)} calls "
              f"{sorted(shapes)}, lengths {c * k_round}: kernel vs plain, max (|err| - 2e-2 "
              f"|plain|) {worst:.3g} (tol 2e-2)")
        k2[c * k_round] = worst
        if k_round == 24:  # mid-run of the timed window: the case timed
            q, k, v, km, kw = calls[0]
            m4 = km[:, None, None, :]
            case = dict(
                ms=cuda_ms(lambda i: flash_attention_fwd(q, k, v, km, **kw), 50),
                plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(q, k, v, km, **kw), 20),
                library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=m4, scale=kw["scale"]), 50))
            case["bound_ms"], case["bound_by"] = _attn_bound(8, AVATAR_MAX, 48, torch.bfloat16,
                                                             km, False, False)
            say(f"K2 at the avatar's masked decode (8, {AVATAR_MAX}, 48) bf16, lengths "
                f"{c * k_round}: kernel {case['ms'] * 1e3:.1f} us, plain "
                f"{case['plain_ms'] * 1e3:.1f} us, SDPA {case['library_ms'] * 1e3:.1f} us, "
                f"bound {case['bound_ms'] * 1e3:.2f} us ({case['bound_by']})")
    res["k2_err"], res["k2_case"] = k2, case

    # steady fused rounds never wait for the card: a pipeline that keeps every
    # download in flight, rounds 2-4 under the sync debug mode
    r16 = renderer(torch.bfloat16)
    pipe = _avatar_pipes(model, r16, src, depth=AVATAR_MAX)["fused"]()
    pipe.push(sp[:, :c], au[:, :c])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(1, 4):
                pipe.push(sp[:, i * c: (i + 1) * c], au[:, i * c: (i + 1) * c])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught
             if "called a synchronizing" in str(w.message)]
    check(not syncs, f"fused rounds 2-4 enqueue with no synchronizing call: {syncs[:3]}")
    res["k1_bf16"] = _avatar_k1_check(pipe, sp, au, 4, 2e-2, "bf16")
    pipe.flush()
    del pipe

    timed = {}
    for cfg, warp in (("bench", None), ("mixed", torch.float32)):
        rend = r16 if warp is None else renderer(torch.bfloat16, warp)
        for name, r in _avatar_timed(_avatar_pipes(model, rend, src), sp, au, cfg).items():
            timed[f"{name}_{cfg}"] = r
        torch.cuda.empty_cache()
    res["timed"] = timed
    return res


RT_PAIRS, RT_REPS, RT_LR = 4, 10, 1e-4
# the card against the CPU, fp32 with TF32 off, a step of each stage from the
# same weights. The warp's bilinear sampling has a gradient that jumps where
# a sampling point crosses a pixel edge, so a step's gradients move with the
# flow's last digits: the CPU's own gradients, with every weight changed by
# 1e-6 of itself, move about as far as the card's do (RT_SENSITIVITY_EPS);
# the card is held within RT_GRAD_FACTOR times that, in the largest error
# and in relative L2. A fresh Adam's step is lr times the sign of each
# gradient, so the two sides' updates differ by 2 lr where a near-zero
# gradient's sign differs and by rounding elsewhere: the share of the
# stepped elements whose updates differ by more than RT_PARAM_WITHIN is held
# within RT_GRAD_FACTOR times the CPU's own share after the same change of
# the weights. The control: the gen step on the card with TF32 on must fail
# both holds
RT_LOSS_TOL, RT_SENSITIVITY_EPS, RT_GRAD_FACTOR = 1e-4, 1e-6, 2.0
RT_PARAM_WITHIN = 1e-8
RT_COEFF = 58


def _rt_batch(pairs, seed):
    """``pairs`` source / target pairs at 256 x 256 (smooth images, as
    ``_render_inputs``) with 58-d windows of radius 13, a numpy batch."""
    import numpy as np

    g = torch.Generator().manual_seed(seed)
    imgs = torch.nn.functional.interpolate(torch.rand(2 * pairs, 3, 16, 16, generator=g) * 2 - 1,
                                           size=(RENDER_RES, RENDER_RES), mode="bilinear",
                                           align_corners=False)
    imgs = imgs.permute(0, 2, 3, 1).contiguous().numpy()
    rng = np.random.default_rng(seed)
    sem = rng.normal(0, 0.3, (2 * pairs, RT_COEFF, 2 * RENDER_RADIUS + 1)).astype(np.float32)
    return {"source_image": imgs[:pairs], "target_image": imgs[pairs:],
            "source_semantics": sem[:pairs], "target_semantics": sem[pairs:]}


def _grad_distance(got, want):
    """(largest error / largest gradient, relative L2 error, the leaf of the
    largest error) between two lists of (name, gradient)."""
    largest = max(float(g.abs().max()) for _, g in want)
    worst = max((float((a - b).abs().max()), n) for (_, a), (n, b) in zip(got, want))
    l2 = float(torch.cat([(a - b).flatten() for (_, a), (_, b) in zip(got, want)]).norm()
               / torch.cat([b.flatten() for _, b in want]).norm())
    return worst[0] / largest, l2, worst[1]


def _rt_grads(trainer):
    return [(n, p.grad.cpu()) for n, p in trainer.net.named_parameters() if p.grad is not None]


def _rt_update(trainer, start, grads):
    """What a step added to each parameter that it had a gradient for."""
    sd = trainer.net.state_dict()
    return {n: sd[n].cpu() - start[n] for n, _ in grads}


def _update_off(got, want):
    """(share of the elements whose updates differ by more than
    RT_PARAM_WITHIN, largest difference)."""
    d = torch.cat([(got[n] - v).abs().flatten() for n, v in want.items()])
    return float((d > RT_PARAM_WITHIN).float().mean()), float(d.max())


def _rt_sensitivity(sd, vgg, batch, root, pretrain):
    """A step on the CPU (the warp stage when ``pretrain`` is 1, the gen
    stage when 0) with every weight of the generator scaled by
    1 + RT_SENSITIVITY_EPS * N(0, 1), seeded: its gradients and update."""
    g = torch.Generator().manual_seed(5)
    moved = {k: v * (1 + RT_SENSITIVITY_EPS * torch.randn(v.shape, generator=g))
             if v.is_floating_point() else v for k, v in sd.items()}
    trainer = _rt_trainer(moved, vgg, "cpu", pretrain, root)
    trainer.optimize_parameters(batch)
    grads = _rt_grads(trainer)
    return grads, _rt_update(trainer, moved, grads)


def _rt_check(sd, vgg, root):
    """A warp step, then a gen step, of 1 pair on the CPU and on the card
    from the same weights (the card's generator takes the CPU's before the
    gen step, whose fresh Adam leaves nothing else behind): losses,
    gradients and updates held as RT_* says, then the TF32 control.
    Returns the errors and K1-K4 launches of the two card steps."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    cpu = _rt_trainer(sd, vgg, "cpu", 1, os.path.join(root, "cpu"))
    card = _rt_trainer(sd, vgg, "cuda", 1, os.path.join(root, "card"))
    errs, launches, t_cpu = {}, {}, 0.0
    for i, stage in enumerate(("warp", "gen")):
        batch = _rt_batch(1, 80 + i)
        start = {k: v.clone() for k, v in cpu.net.state_dict().items()}
        card.net.load_state_dict(start)
        t0 = time.perf_counter()
        lc = cpu.optimize_parameters(batch)
        t_cpu += time.perf_counter() - t0
        kernels.reset_launch_counts()
        lg = card.optimize_parameters(batch)
        torch.cuda.synchronize()
        launches[f"check_{stage}_step"] = dict(kernels.LAUNCHES)
        rel = {k: abs(lg[k] - v) / abs(v) for k, v in lc.items()}
        errs[f"{stage}_loss_rel"] = rel
        check(sorted(lg) == sorted(lc) and max(rel.values()) <= RT_LOSS_TOL,
              f"render train {stage} step on the card vs the CPU: losses {lg} vs {lc}, "
              f"largest rel err {max(rel.values()):.3g} (tol {RT_LOSS_TOL})")
        gc, gg = _rt_grads(cpu), _rt_grads(card)
        gerr, l2, worst = _grad_distance(gg, gc)
        s_grads, s_update = _rt_sensitivity(start, vgg, batch, os.path.join(root, "s"), i ^ 1)
        s_max, s_l2, _ = _grad_distance(s_grads, gc)
        errs.update({f"{stage}_grad_rel": gerr, f"{stage}_grad_rel_l2": l2,
                     f"{stage}_grad_worst": worst, f"{stage}_cpu_sensitivity_rel": s_max,
                     f"{stage}_cpu_sensitivity_rel_l2": s_l2})
        check([n for n, _ in gc] == [n for n, _ in gg]
              and gerr <= RT_GRAD_FACTOR * s_max and l2 <= RT_GRAD_FACTOR * s_l2,
              f"render train {stage} step's gradients on the card vs the CPU: largest "
              f"error {gerr:.3g} of the largest gradient (at {worst}), relative L2 {l2:.3g}; "
              f"the CPU's own after a {RT_SENSITIVITY_EPS:g} relative change of the weights: "
              f"{s_max:.3g}, {s_l2:.3g} (tol {RT_GRAD_FACTOR:g}x)")
        uc = _rt_update(cpu, start, gc)
        off, umax = _update_off(_rt_update(card, start, gc), uc)
        s_off, _ = _update_off(s_update, uc)
        errs.update({f"{stage}_update_off_share": off, f"{stage}_update_max_abs": umax,
                     f"{stage}_cpu_sensitivity_update_off_share": s_off})
        check(off <= RT_GRAD_FACTOR * s_off, f"render train {stage} step's update on the card "
              f"vs the CPU: {100 * off:.3f}% of the stepped elements differ by more than "
              f"{RT_PARAM_WITHIN:g} (largest {umax:.3g}, lr {RT_LR:g}); the CPU's own after "
              f"the same change of the weights: {100 * s_off:.3f}% (tol {RT_GRAD_FACTOR:g}x)")
        if stage == "gen":  # the control: TF32 on fails both holds
            flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl = _rt_trainer(start, vgg, "cuda", 0, os.path.join(root, "ctl"))
                ctl.optimize_parameters(batch)
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            c_max, c_l2, _ = _grad_distance(_rt_grads(ctl), gc)
            c_off, _ = _update_off(_rt_update(ctl, start, gc), uc)
            errs.update(control_tf32_grad_rel=c_max, control_tf32_grad_rel_l2=c_l2,
                        control_tf32_update_off_share=c_off)
            check((c_max > RT_GRAD_FACTOR * s_max or c_l2 > RT_GRAD_FACTOR * s_l2)
                  and c_off > RT_GRAD_FACTOR * s_off,
                  f"control: the gen step with TF32 on fails both holds: gradients' largest "
                  f"error {c_max:.3g} (bound {RT_GRAD_FACTOR * s_max:.3g}), relative L2 "
                  f"{c_l2:.3g} (bound {RT_GRAD_FACTOR * s_l2:.3g}); update "
                  f"{100 * c_off:.3f}% off (bound {100 * RT_GRAD_FACTOR * s_off:.3f}%)")
            del ctl
    say(f"render train: 2 steps of 1 pair on the CPU (the reference) {t_cpu:.1f} s")
    return errs, launches


def _rt_trainer(sd, vgg, device, pretrain, save_dir):
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.trainer import FaceTrainer

    model = FaceGenerator(flame_coeff_nc=RT_COEFF, coeff_nc=73).to(device)
    model.load_state_dict(sd, strict=True)
    return FaceTrainer(model, pretrain_warp_iteration=pretrain, vgg_state_dict=vgg,
                       base_lr=RT_LR, save_dir=save_dir)


def _rt_timed(trainer, batch, what):
    """One stage's step: median ms of RT_REPS between CUDA events, peak
    memory, launches of one step, 3 steps traced."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    ms = cuda_ms(lambda i: trainer.optimize_parameters(batch), RT_REPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trainer.optimize_parameters(batch)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(all(v == 0 for v in launches.values()), f"render train {what} step launched no "
          f"K1-K4: {launches}")
    windows, top = _trace_steps(trainer.optimize_parameters, (batch,), f"render train {what}")
    images = 2 * RT_PAIRS
    say(f"render train {what} step, {RT_PAIRS} pairs ({images} images) at {RENDER_RES}x"
        f"{RENDER_RES}, {CARD[-1]}: median {ms:.2f} ms -> {images / ms * 1e3:.1f} images/s, "
        f"peak {peak:.0f} MiB, card busy {100 * windows['card']['busy_share']:.1f}% of 3 "
        "traced steps")
    return {"step_ms": ms, "images_per_s": images / ms * 1e3, "peak_mib": peak,
            "launches": launches, "busy_share": windows["card"]["busy_share"],
            "traced_windows": windows,
            "top_kernels": [{"name": n[:120], "ms": t / 1e3, "launches": c}
                            for n, t, c in top[:8]]}


@phase
def render_train_path():
    """PIRender's FaceTrainer at full width, checked against the CPU, both
    stages timed in fp32 with TF32 off and on, then the render_train twin at
    256 x 256 and render_inference on its checkpoint."""
    import shutil
    import tempfile

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import render_inference, render_train
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.perceptual import make_trunk
    from dyadic_interaction_modeling_tpu_torch.render.trainer import LAYERS

    torch.manual_seed(71)
    sd = {k: v.clone() for k, v in FaceGenerator(flame_coeff_nc=RT_COEFF,
                                                  coeff_nc=73).state_dict().items()}
    torch.manual_seed(72)
    vgg = {k: v.clone() for k, v in make_trunk("vgg19", LAYERS).state_dict().items()}
    root = tempfile.mkdtemp(prefix="render_train_")
    out = {"launches": {}}
    try:
        out["cpu_check"], out["launches"] = _rt_check(sd, vgg, root)
        check(all(v == 0 for c in out["launches"].values() for v in c.values()),
              f"render train steps launched no K1-K4: {out['launches']}")
        # both stages timed, fp32 with TF32 off and on
        batch_np = _rt_batch(RT_PAIRS, 90)
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        try:
            for name, tf32 in (("fp32", False), ("tf32", True)):
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
                for stage, pretrain in (("warp", 10 ** 9), ("gen", 0)):
                    trainer = _rt_trainer(sd, vgg, "cuda", pretrain, os.path.join(root, name))
                    out[f"{stage}_{name}"] = _rt_timed(trainer, trainer.upload(batch_np),
                                                       f"{stage} ({name})")
                    out["launches"][f"{stage}_{name}_step"] = out[f"{stage}_{name}"]["launches"]
                    del trainer
                    torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        # the twin end to end at 256 x 256, and render_inference on its checkpoint
        runs = {}
        for name, main, argv in (
                ("render_train", render_train.main,
                 ["--synthetic", "--resolution", str(RENDER_RES), "--coeff-nc", "56",
                  "--debug", "3", "--device", "cuda", "--save-path",
                  os.path.join(root, "twin")]),
                ("render_inference", render_inference.main,
                 ["--synthetic", "--checkpoint", os.path.join(root, "twin", "step_3.pt"),
                  "--out", os.path.join(root, "frames"), "--resolution", str(RENDER_RES),
                  "--device", "cuda"])):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            got = main(argv)
            torch.cuda.synchronize()
            runs[name] = {"s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES)}
            out["launches"][name] = runs[name]["launches"]
            say(f"{name}: {runs[name]['s']:.1f} s, launches {runs[name]['launches']}")
            check(all(v == 0 for v in runs[name]["launches"].values()),
                  f"{name} launched no K1-K4")
            if name == "render_train":
                check(got.iteration == 3 and os.path.exists(os.path.join(
                    root, "twin", "step_3.pt")), "render_train --debug 3 took 3 steps and "
                      "wrote step_3.pt")
            else:
                import numpy as np

                n = len(os.listdir(os.path.join(root, "frames", "fake")))
                check(n == 6 and bool(np.isfinite(got["fake_image"]).all()),
                      f"render_inference read the twin's checkpoint: {n} finite frames of 6")
        out["twins"] = runs
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


MESH_VQ = ["epochs", "2"]


@phase
def mesh_path():
    """``cli.train_vq --synthetic --mesh data=1`` on the card (NCCL, a group
    of one) against the same run without ``--mesh``: the best validation
    rec_loss within 1e-5 relative, the same K1-K4 counts; the device-count
    error of ``data=2`` on one card."""
    import json as _json
    import shutil
    import tempfile

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import train_vq
    from dyadic_interaction_modeling_tpu_torch.parallel import MeshPlan

    root = tempfile.mkdtemp(prefix="mesh_")
    runs = {}
    try:
        for name, extra in (("single", []), ("mesh_data=1", ["--mesh", "data=1"])):
            save = os.path.join(root, name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            train_vq.main(["--synthetic", "--device", "cuda", "--save-path", save] + extra
                          + MESH_VQ)
            torch.cuda.synchronize()
            with open(os.path.join(save, "scalars.jsonl")) as f:
                vals = [r["value"] for r in map(_json.loads, f) if r["tag"] == "val/rec_loss"]
            runs[name] = {"s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                          "best_rec_loss": min(vals)}
            say(f"train_vq --synthetic {' '.join(extra)}: {runs[name]['s']:.1f} s, best val "
                f"rec_loss {runs[name]['best_rec_loss']:.6f}, launches {runs[name]['launches']}")
        a, b = runs["single"], runs["mesh_data=1"]
        rel = abs(a["best_rec_loss"] - b["best_rec_loss"]) / abs(a["best_rec_loss"])
        check(rel <= 1e-5, f"train_vq --mesh data=1 (NCCL) best loss vs no mesh: rel err "
              f"{rel:.3g} (tol 1e-5)")
        check(a["launches"] == b["launches"], f"train_vq launches with and without --mesh: "
              f"{b['launches']} vs {a['launches']}")
        try:
            MeshPlan.parse("data=2", "cuda")
            check(False, "MeshPlan.parse('data=2') on one card raises")
        except ValueError as e:
            check("needs 2 devices" in str(e), f"MeshPlan.parse('data=2') on one card: {e}")
        return {"runs": runs, "best_rel_err": rel}
    finally:
        shutil.rmtree(root, ignore_errors=True)


@phase
def vq_attention_routes():
    """The VQ attention by both routes, forward and backward, graph-timed
    (the card alone): the matmul path (``attend``) and K2/K3, at the
    listener's D = 48 and the speaker's D = 96, L = 256, 512, 768 and 1024, 8
    rows (one clip, 8 heads), fp32 and bf16. These set ``FLASH_MIN_LEN``,
    the VQ attention's gate (``ops/transformer.py``)."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention
    from dyadic_interaction_modeling_tpu_torch.ops.transformer import attend

    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for (d, scale), dt, l in itertools.product(((48, VQ_SCALE), (96, SPK_SCALE)),
                                               (torch.float32, torch.bfloat16),
                                               (256, 512, 768, 1024)):
        q, k, v, do = (torch.randn(1, 8, l, d, device="cuda", generator=g).to(dt)
                       for _ in range(4))
        routes = {"attend": lambda q, k, v, scale=scale: attend(q, k, v, scale, None),
                  "flash": lambda q, k, v, scale=scale: flash_attention(
                      q[0], k[0], v[0], scale=scale)[None]}
        for route, f in routes.items():
            fwd, _ = _autograd_pair(f, (q, k, v), do)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _, bwd = _autograd_pair(f, (q, k, v), do)
            torch.cuda.current_stream().wait_stream(side)
            r = {"fwd_graph_ms": graph_ms(fwd), "bwd_graph_ms": graph_ms(bwd, stream=side)}
            out[f"{route} {str(dt)[6:]} D={d} L={l}"] = r
            say(f"VQ attention (8,{l},{d}) {str(dt)[6:]} by {route}: forward "
                f"{r['fwd_graph_ms'] * 1e3:.1f} us, backward {r['bwd_graph_ms'] * 1e3:.1f} "
                "us (from a CUDA graph)")
        del q, k, v, do
    return out


@phase
def timings(main):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)
    import torch.nn.functional as F

    model, gen, batch, _ = main
    tensors = tuple(torch.as_tensor(x, device="cuda") for x in batch[:4])
    rng = torch.Generator(device="cuda").manual_seed(11)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen(tensors, rng, N)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    say(f"best-of-{N} generate, {B0} clips x L={L}, bf16: median {med * 1e3:.1f} ms "
        f"of {[round(t * 1e3, 1) for t in times]} -> {B0 * N * (L - 1) / med:.0f} "
        f"sampled frames/s")

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    out = {}
    # ms: single launches between CUDA events (a K1 self sweep t = 0..255
    # between a pair, / 256), which also times the host's path to the launch;
    # graph_ms: the same launches replayed from a CUDA graph, the card alone
    # K1 self: the mean launch of a generate is the sweep t = 0..255 (4 input
    # sets, one per decoder layer, so the 196 MB caches do not sit in L2)
    sets = _k1_inputs(3000, 1, bf, g, n_sets=4)
    nbytes = sum(3000 * 64 * 2 * 2 * (t + 1) for t in range(L)) / L + 2 * 3000 * 64 * 2
    ops = sum(4 * 3000 * 64 * (t + 1) for t in range(L)) / L

    def sweep(fn):
        return lambda i=0: [fn(*sets[(i + t) % 4][:3], t) for t in range(L)]

    kern = sweep(lambda q, k, v, t: decode_attention(q, k, v, t, scale=0.125))
    plain = sweep(lambda q, k, v, t: decode_attention_plain(q, k, v, t, scale=0.125))
    sdpa = sweep(lambda q, k, v, t: F.scaled_dot_product_attention(
        q[:, None], k[:, None, : t + 1], v[:, None, : t + 1], scale=0.125))
    out["self"] = dict(ms=cuda_ms(kern, 7) / L, plain_ms=cuda_ms(plain, 3) / L,
                       library_ms=cuda_ms(sdpa, 7) / L, graph_ms=graph_ms(kern, inner=1) / L,
                       library_graph_ms=graph_ms(sdpa, inner=1) / L)
    out["self"]["bound_ms"], out["self"]["bound_by"] = bound_ms(nbytes, ops, bf)
    del sets
    # K1 cross: (300, 10, 64) and MQA cross (25, 120, 64) against the full
    # L=256 context, key mask
    for name, rows, nq, group in (("cross", 300, 10, 12), ("mqa_cross", 25, 120, 1)):
        sets = _k1_inputs(rows, nq, bf, g, masked=True, n_sets=4, group=group)
        nbytes = rows * L * 64 * 2 * 2 + 2 * rows * nq * 64 * 2 + (rows // group) * L
        masks4 = [s[3].repeat_interleave(group, 0)[:, None, None, :] for s in sets]

        def kern(i=0, sets=sets):
            return decode_attention(*sets[i % 4][:3], None, sets[i % 4][3], scale=0.125)

        def plain(i=0, sets=sets):
            return decode_attention_plain(*sets[i % 4][:3], None, sets[i % 4][3], scale=0.125)

        def sdpa(i=0, sets=sets, masks4=masks4):
            return F.scaled_dot_product_attention(
                sets[i % 4][0][:, None], sets[i % 4][1][:, None], sets[i % 4][2][:, None],
                attn_mask=masks4[i % 4], scale=0.125)

        r = dict(ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 50),
                 library_ms=cuda_ms(sdpa, 200),
                 graph_ms=graph_ms(lambda: [kern(i) for i in range(4)]) / 4,
                 library_graph_ms=graph_ms(lambda: [sdpa(i) for i in range(4)]) / 4)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 4 * rows * nq * L * 64, bf)
        out[name] = r
        del sets, masks4
    # K4: (n, 128) latents x (512, 128) codebook, fp32: n = 6400 in a
    # generate, 1024 in a VQ training step and twice in a finetune step, 8192
    # in a speaker VQ training step
    for name, n in (("vq", 6400), ("vq_1024", 1024), ("vq_8192", 8192)):
        z = torch.randn(n, 128, device="cuda", generator=g)
        e = torch.randn(512, 128, device="cuda", generator=g)
        r = dict(ms=cuda_ms(lambda i: nearest_code(z, e), 200),
                 plain_ms=cuda_ms(lambda i: nearest_code_plain(z, e), 200), library_ms=None,
                 graph_ms=graph_ms(lambda: nearest_code(z, e)), library_graph_ms=None)
        r["bound_ms"], r["bound_by"] = bound_ms(n * 128 * 4 + 512 * 128 * 4 + n * 4,
                                                2 * n * 512 * 128, torch.float32)
        out[name] = r
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms'] * 1e3:.2f} us (graph {r['library_graph_ms'] * 1e3:.2f} us)")
        say(f"{name:9s}: kernel {r['ms'] * 1e3:.2f} us (graph {r['graph_ms'] * 1e3:.2f} us), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return {"generate_ms": med * 1e3, "generate_runs_ms": [t * 1e3 for t in times],
            **out}


def _flash_entry(name, line, which, tt, k23, by_path):
    cases = tt["cases"]
    return {"name": name, "route": "cuda", "source": SOURCES[torch.bfloat16],
            "sources_by_dtype": {str(k).replace("torch.", ""): v for k, v in SOURCES.items()},
            "replaces": f"dyadic_interaction_modeling_tpu/ops/pallas/attention.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k23["bfloat16"]["fwd_abs" if which == "fwd" else "bwd_abs"],
            # launch-weighted means over one SLM training step's 20 launches
            **{key: val / 20 for key, val in tt["per_step"][which].items()},
            "bound_by": max((c[which] for c in cases.values() if c["per_step"]),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "cases": {k: c[which] for k, c in cases.items()}, "max_err": k23}


def kernels_line(gen_launches, mqa_launches, mqa_wide, train, vq, ft, spk, rf, k4, k1, k23,
                 t, tt, routes, refs, ft64, build_s, ptxas, biwi, s2s, speech, render, avatar,
                 rt, mesh):
    self_, cross = t["self"], t["cross"]
    mean = {key: (self_[key] + cross[key]) / 2
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "graph_ms",
                        "library_graph_ms")}
    paths = {f"train_{TRAIN_STEPS}_steps": train["launches"],
             f"vq_train_{TRAIN_STEPS}_steps": vq["launches"],
             f"finetune_{TRAIN_STEPS}_steps": ft["launches"],
             f"speaker_vq_train_{TRAIN_STEPS}_steps": spk["launches"],
             **{f"real_files_{name}": r["launches"] for name, r in rf["runs"].items()},
             f"speaker_generate_best_of_{BIWI_N}": biwi["generate"]["launches"],
             "test_biwi": biwi["test_biwi"]["launches"],
             f"speaker_finetune_{TRAIN_STEPS}_steps": biwi["finetune"]["launches"],
             "train_converter_2_epochs": biwi["converter"]["launches"],
             f"converter_{TRAIN_STEPS}_steps": biwi["converter"]["step_launches"],
             f"s2s_train_{TRAIN_STEPS}_steps": s2s["train"]["launches"],
             "s2s_generate_batch": s2s["generate"]["launches"],
             **{f"s2s_files_{name}": r["launches"]
                for name, r in s2s["generate"]["twins"].items()},
             f"streaming_session_{STREAM_ROUNDS}_rounds": s2s["streaming"]["launches"],
             f"pool_{POOL_ROUNDS}_rounds": s2s["pool"]["launches"],
             "speaker_streaming_session": s2s["speaker_streaming"]["launches"],
             f"codetalker_train_{TRAIN_STEPS}_steps": speech["train"]["launches"],
             f"codetalker_predict_{BIWI_L}_frames": speech["predict"]["launches"],
             **{f"speech_files_{name}": r["launches"]
                for name, r in speech["files"]["runs"].items()},
             f"render_clip_{RENDER_T}_frames": render["launches"],
             **{f"render_files_{name}": r["launches"]
                for name, r in render["files"]["runs"].items()},
             **{f"avatar_{name}_round": r["launches"] for name, r in avatar["timed"].items()},
             **{f"render_train_{name}": c for name, c in rt["launches"].items()},
             **{f"mesh_train_vq_{name}": r["launches"] for name, r in mesh["runs"].items()}}

    def by_path(name, generate=None):
        out = {} if generate is None else generate
        return {**out, **{path: counts[name] for path, counts in paths.items()}}

    wide = f"generate_mqa_best_of_{MQA_WIDE_N}"
    k4_paths = by_path("nearest_code", {"generate": gen_launches["nearest_code"],
                                        "generate_mqa": mqa_launches["nearest_code"],
                                        wide: mqa_wide["nearest_code"]})
    return {"kernels": [
        {"name": "decode_attention", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/decode_attention.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129",
         "launches": gen_launches["decode_attention"],
         "launches_by_path": by_path("decode_attention", {
             "generate": gen_launches["decode_attention"],
             "generate_mqa": mqa_launches["decode_attention"],
             wide: mqa_wide["decode_attention"]}),
         "max_abs_err": k1["bfloat16"], **mean, "bound_by": "bytes",
         "cases": {"self (3000,1,64) L=256 t=0..255 bf16": self_,
                   "cross (300,10,64) L=256 masked bf16": cross,
                   "MQA cross (25,120,64) L=256 masked bf16": t["mqa_cross"],
                   f"speaker self ({BIWI_N * HEADS},1,64) t=0..{BIWI_L - 2} fp32":
                       biwi["k1"]["speaker_self"],
                   f"speaker cross ({HEADS},{BIWI_N},64) L={BIWI_L} masked fp32":
                       biwi["k1"]["speaker_cross"],
                   "max_abs_err": k1, "speaker_cross_max_abs_err":
                       biwi["generate"]["k1_cross_err"],
                   "avatar_round_max_abs_err": {"float32": avatar["k1_fp32"]["max_abs_err"],
                                                "bfloat16": avatar["k1_bf16"]["max_abs_err"]}}},
        {**_flash_entry("flash_attention_fwd", 111, "fwd", tt, k23,
                        by_path("flash_attention_fwd", {"generate": 0})),
         "avatar_case": {"(8,1024,48) bf16 key mask, lengths 192 (the avatar's masked decode)":
                         avatar["k2_case"], "max_err_by_lengths": avatar["k2_err"]}},
        _flash_entry("flash_attention_bwd", 152, "bwd", tt, k23,
                     by_path("flash_attention_bwd", {"generate": 0})),
        {"name": "nearest_code", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49",
         "launches": sum(v for k, v in k4_paths.items() if not k.startswith("generate_mqa")),
         "launches_by_path": k4_paths,
         "max_abs_err": k4["max_abs_err"], **t["vq"], "agree": k4["agree"],
         "cases": {"(6400,128) x (512,128) fp32 (generate)": t["vq"],
                   "(1024,128) x (512,128) fp32 (VQ training, finetune)": t["vq_1024"],
                   "(8192,128) x (512,128) fp32 (speaker VQ training)": t["vq_8192"],
                   f"({BIWI_L},128) x (512,128) fp32 (CodeTalker training; predict's last "
                   "frame)": speech["predict"]["k4_time"]},
         "on_path_latents": {path: r["k4"] for path, r in refs.items()}},
    ], "generate_ms": t["generate_ms"], "generate_runs_ms": t["generate_runs_ms"],
        "train_step_ms": train["step_ms"], "train_step_runs_ms": train["step_runs_ms"],
        "train_frames_per_s": TRAIN_B * L / train["step_ms"] * 1e3,
        "train_busy_share": tt["busy_share"], "train_traced_windows": tt["windows"],
        "vq_train_step_ms": vq["step_ms"], "vq_train_step_runs_ms": vq["step_runs_ms"],
        "vq_train_frames_per_s": VQ_L / vq["step_ms"] * 1e3,
        "vq_train_busy_share": vq["windows"]["card"]["busy_share"],
        "vq_train_traced_windows": vq["windows"],
        "finetune_step_ms": ft["step_ms"], "finetune_step_runs_ms": ft["step_runs_ms"],
        "finetune_frames_per_s": FT_B * L / ft["step_ms"] * 1e3,
        "finetune_busy_share": ft["windows"]["card"]["busy_share"],
        "finetune_traced_windows": ft["windows"],
        "speaker_vq_train_step_ms": spk["step_ms"],
        "speaker_vq_train_step_runs_ms": spk["step_runs_ms"],
        "speaker_vq_train_frames_per_s": VQ_L / spk["step_ms"] * 1e3,
        "speaker_vq_train_busy_share": spk["windows"]["card"]["busy_share"],
        "speaker_vq_train_traced_windows": spk["windows"],
        "speaker_vq_reference": refs["speaker_vq_train"], "real_files": rf,
        "finetune_fp64_reference": ft64, "vq_attention_routes": routes, "build_s": build_s,
        "ptxas_fp32_attention": ptxas,
        "speaker_generate_ms": biwi["generate"]["generate_ms"],
        "speaker_generate_runs_ms": biwi["generate"]["generate_runs_ms"],
        "speaker_generate_sampled_frames_per_s":
            BIWI_N * (BIWI_L - 1) / biwi["generate"]["generate_ms"] * 1e3,
        "test_biwi": biwi["test_biwi"],
        "speaker_finetune_step_ms": biwi["finetune"]["step_ms"],
        "speaker_finetune_step_runs_ms": biwi["finetune"]["step_runs_ms"],
        "speaker_finetune_frames_per_s": BIWI_B * BIWI_L / biwi["finetune"]["step_ms"] * 1e3,
        "speaker_finetune_busy_share": biwi["finetune"]["windows"]["card"]["busy_share"],
        "speaker_finetune_traced_windows": biwi["finetune"]["windows"],
        "speaker_finetune_reference": {k: biwi["finetune"][k] for k in (
            "loss_rel", "grad_rel", "grad_rel_leaf", "fp64")},
        "converter_step_ms": biwi["converter"]["step_ms"],
        "converter_step_runs_ms": biwi["converter"]["step_runs_ms"],
        "converter_busy_share": biwi["converter"]["windows"]["card"]["busy_share"],
        "converter_losses": biwi["converter"]["losses"],
        "s2s_train_step_ms": s2s["train"]["step_ms"],
        "s2s_train_step_runs_ms": s2s["train"]["step_runs_ms"],
        "s2s_train_frames_per_s": S2S_B * L / s2s["train"]["step_ms"] * 1e3,
        "s2s_train_busy_share": s2s["train"]["windows"]["card"]["busy_share"],
        "s2s_train_traced_windows": s2s["train"]["windows"],
        "s2s_train_reference": {k: v for k, v in s2s["train_ref"].items() if k != "k4"},
        "s2s_generate_ms": s2s["generate"]["generate_ms"],
        "s2s_generate_runs_ms": s2s["generate"]["generate_runs_ms"],
        "s2s_teacher_forced_err": s2s["generate"]["teacher_forced_err"],
        "s2s_twins": s2s["generate"]["twins"],
        "streaming": {k: v for k, v in s2s["streaming"].items() if k != "launches"},
        "pool": {k: v for k, v in s2s["pool"].items() if k != "launches"},
        "speaker_streaming": {k: v for k, v in s2s["speaker_streaming"].items()
                              if k != "launches"},
        "speech_trunk_ms_per_clip": speech["trunk"]["ms_per_clip"],
        "speech_trunk_rel_err": speech["trunk"]["rel_err"],
        "codetalker_train_step_ms": speech["train"]["step_ms"],
        "codetalker_train_step_runs_ms": speech["train"]["step_runs_ms"],
        "codetalker_train_frames_per_s": BIWI_L / speech["train"]["step_ms"] * 1e3,
        "codetalker_train_busy_share": speech["train"]["windows"]["card"]["busy_share"],
        "codetalker_train_traced_windows": speech["train"]["windows"],
        "codetalker_train_reference": {k: speech["train"][k] for k in (
            "loss_rel", "grad_rel", "grad_rel_leaf", "losses_first", "losses_last")},
        "codetalker_predict_ms": speech["predict"]["ms"],
        "codetalker_predict_runs_ms": speech["predict"]["runs_ms"],
        "codetalker_predict_motion_rel_err": speech["predict"]["motion_rel_err"],
        "speech_files": speech["files"], "audio_frontend": speech["frontend"],
        "render": render, "avatar": {k: v for k, v in avatar.items() if k != "k2_case"},
        "render_train": {k: v for k, v in rt.items() if k != "launches"}, "mesh": mesh}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dyadic_interaction_modeling_tpu_torch  # noqa: F401 - fails alone

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = device()
    built = build()
    build_s, ptxas = built if built else (None, None)
    k4 = k4_check()
    k1 = k1_check()
    k23 = k23_check()
    main_run = slice_main_path()
    slice_reference()
    t = timings(main_run) if main_run else None
    gen_launches = main_run[3] if main_run else None
    del main_run
    torch.cuda.empty_cache()
    mqa = mqa_main_path()
    mqa_launches, mqa_wide = mqa if mqa else (None, None)
    mqa_ref = mqa_reference()
    mqa_wide_ref = mqa_wide_reference()
    train = train_main_path()
    train_ref = train_reference()
    tt = train_timings(train) if train else None
    vq = vq_train_main_path()
    vq_ref = vq_train_reference()
    torch.cuda.empty_cache()
    ft = finetune_main_path()
    ft_ref = finetune_reference()
    ft64 = finetune_fp64_reference()
    torch.cuda.empty_cache()
    spk = speaker_vq_train_main_path()
    spk_ref = speaker_vq_train_reference()
    torch.cuda.empty_cache()
    rf = real_files_path()
    torch.cuda.empty_cache()
    biwi = {"generate": speaker_generate_path()}
    torch.cuda.empty_cache()
    biwi["test_biwi"] = test_biwi_twin()
    torch.cuda.empty_cache()
    biwi["finetune"] = speaker_finetune_path()
    torch.cuda.empty_cache()
    biwi["converter"] = converter_path()
    torch.cuda.empty_cache()
    biwi["k1"] = speaker_timings()
    torch.cuda.empty_cache()
    s2s = {"train": s2s_train_path(), "train_ref": s2s_train_reference()}
    s2s["generate"] = s2s_generate_path(s2s["train"]) if s2s["train"] else None
    torch.cuda.empty_cache()
    s2s["streaming"] = streaming_path()
    torch.cuda.empty_cache()
    s2s["pool"] = pool_path()
    torch.cuda.empty_cache()
    s2s["speaker_streaming"] = speaker_streaming_path()
    torch.cuda.empty_cache()
    speech = {"trunk": speech_trunk_path()}
    torch.cuda.empty_cache()
    speech["train"] = codetalker_train_path()
    torch.cuda.empty_cache()
    speech["predict"] = codetalker_predict_path(speech["train"]) if speech["train"] else None
    if speech["train"]:
        del speech["train"]["state"]
    torch.cuda.empty_cache()
    speech["files"] = speech_files_path()
    torch.cuda.empty_cache()
    speech["frontend"] = audio_frontend_path()
    torch.cuda.empty_cache()
    render = render_path()
    torch.cuda.empty_cache()
    render_files = render_files_path(render) if render else None
    if render:
        for key in ("state_dict", "source", "coeffs"):
            del render[key]
        render["files"] = render_files
    torch.cuda.empty_cache()
    avatar = avatar_path()
    torch.cuda.empty_cache()
    rt = render_train_path()
    torch.cuda.empty_cache()
    mesh = mesh_path()
    torch.cuda.empty_cache()
    routes = vq_attention_routes()
    if FAILURES or None in (smi, build_s, k4, k1, k23, t, mqa_launches, mqa_wide, mqa_ref,
                            mqa_wide_ref, train, train_ref, tt, vq, vq_ref, ft, ft_ref,
                            ft64, spk, spk_ref, rf, routes, *biwi.values(), *s2s.values(),
                            *speech.values(), render, render_files, avatar, rt, mesh):
        say(f"FAILED: {FAILURES}")
        return 1
    refs = {"train": train_ref, "vq_train": vq_ref, "finetune": ft_ref,
            "speaker_vq_train": spk_ref, "speaker_finetune": biwi["finetune"],
            "s2s_train": s2s["train_ref"], "codetalker_train": speech["train"],
            "codetalker_predict": speech["predict"]}
    say(json.dumps(kernels_line(gen_launches, mqa_launches, mqa_wide, train, vq, ft, spk, rf,
                                k4, k1, k23, t, tt, routes, refs, ft64, build_s, ptxas, biwi,
                                s2s, speech, render, avatar, rt, mesh)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
