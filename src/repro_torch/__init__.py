"""PyTorch + CUDA port of the Adaptive Load Balancer (ALB) for graph
analytics, for NVIDIA Hopper (``sm_90a``).

Module names mirror the JAX package ``repro``; this package imports
neither ``jax`` nor ``repro``.  Implemented so far: the single-device,
host-driven, push-direction ALB round (``core.balancer.relax``) and the
bfs / sssp drivers (single-source and batched ``[B, V]``) on top of it.
The two mapping kernels of that path (``kernels/csrc/twc_gather.cu``
and ``kernels/csrc/edge_lb.cu``) are built with ``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.
"""
