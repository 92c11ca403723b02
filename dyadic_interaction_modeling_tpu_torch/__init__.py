"""PyTorch / CUDA port of dyadic_interaction_modeling_tpu for NVIDIA Hopper.

The first slice: SLMFT best-of-N listener generation (``engine.pt_engine``,
``cli.test_s2s_pretrain``), with the decode-attention and VQ-argmin kernels
hand-written in CUDA (``csrc/``, ``kernels/``). Module names mirror the JAX
package's. Entry points run on the GPU (``device="cuda"``) unless the caller
asks for the CPU, where every kernel runs its plain PyTorch version.
"""
