"""The language-model stack of the port: ``layers`` (RMSNorm, RoPE, GQA
and MLA attention, MLP), ``mamba2`` (the SSD block), ``moe``
(ALB-adaptive MoE dispatch), ``transformer`` (init, cache, prefill,
decode_step, forward, every family) and ``convert`` (JAX parameters
into the port's modules)."""
