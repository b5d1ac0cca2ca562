"""PyTorch + CUDA port of the Adaptive Load Balancer (ALB) for graph
analytics, for NVIDIA Hopper (``sm_90a``).

Module names mirror the JAX package ``repro``; this package imports
neither ``jax`` nor ``repro``.  Implemented so far: the single-device
ALB round in push, pull and adaptive direction over three executor
backends, in host, static-shape (``spmd``) and fused modes, the paper's
five apps on top of it (``core.apps``), and the LM serving path
(``models``).  The hand-written CUDA kernels (``kernels/csrc``) are
built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.
"""
