"""The language-model stack of the port: ``layers`` (RMSNorm, RoPE, GQA
attention, MLP), ``moe`` (ALB-adaptive MoE dispatch), ``transformer``
(init, cache, prefill, decode_step) and ``convert`` (JAX parameters
into the port's modules)."""
