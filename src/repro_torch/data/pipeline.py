"""Deterministic synthetic data pipeline (numpy on the host).

A copy of ``repro/data/pipeline.py``, whose generator is numpy: a batch
is a pure function of ``(seed, step)``, bitwise the JAX package's, so

* a restart from a checkpoint replays the exact stream,
* the global batch is the same whatever consumes it.

Tokens are Zipf-distributed, so embedding gathers see a realistic skew
and the MoE router a non-uniform load: the ALB dispatch's reason to
exist.  The caller moves a batch to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def synthetic_batch(seed: int, step: int, global_batch: int, seq_len: int,
                    vocab_size: int, num_codebooks: int = 1,
                    zipf_a: float = 1.2):
    """``{"tokens", "labels"}``, int32 numpy arrays of ``seq_len - 1``
    positions (``[..., num_codebooks]`` when there are several)."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003
                                + np.uint64(step))
    shape = ((global_batch, seq_len) if num_codebooks == 1
             else (global_batch, seq_len, num_codebooks))
    z = rng.zipf(zipf_a, size=shape)
    tokens = np.minimum(z - 1, vocab_size - 1).astype(np.int32)
    return {"tokens": tokens[:, :-1] if num_codebooks == 1
            else tokens[:, :-1, :],
            "labels": tokens[:, 1:] if num_codebooks == 1
            else tokens[:, 1:, :]}


@dataclasses.dataclass
class SyntheticDataset:
    seed: int
    global_batch: int
    seq_len: int
    vocab_size: int
    num_codebooks: int = 1

    def batch(self, step: int):
        # +1 so tokens and labels both have seq_len after the shift
        return synthetic_batch(self.seed, step, self.global_batch,
                               self.seq_len + 1, self.vocab_size,
                               self.num_codebooks)
