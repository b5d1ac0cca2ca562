"""End-to-end training driver.

Port of ``repro/launch/train.py``, with the same flags, log lines and
restart semantics, and one more flag, ``--device`` (cuda unless the
caller names another).  Runs ``--arch`` on one device with:

* deterministic synthetic data (restart-replayable),
* step-granular async checkpointing in the JAX package's format, and
  automatic restart from the newest complete checkpoint,
* a WSD or cosine LR schedule,
* per-step wall clock and the slowest-step watermark (p95) logged.

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      deepseek-moe-16b --smoke --device cpu --steps 20 --batch 8 \\
      --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.graph import resolve_device
from ..data import SyntheticDataset
from ..models import convert
from ..optim import OptConfig, cosine_schedule, wsd_schedule
from ..train.steps import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", choices=["cosine", "wsd"],
                    default="cosine")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    sched = (wsd_schedule(args.lr, warmup=max(args.steps // 20, 1),
                          stable=args.steps * 7 // 10,
                          decay=max(args.steps // 5, 1))
             if args.schedule == "wsd"
             else cosine_schedule(args.lr, max(args.steps // 20, 1),
                                  args.steps))
    opt_cfg = OptConfig(lr=sched)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, opt_state = init_train_state(cfg, generator=gen, device=dev)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        newest = latest_step(args.ckpt_dir)
        if newest is not None:
            tmpl = convert.train_state_to_jax_tree(params, opt_state,
                                                   shapes_only=True)
            restored, manifest = restore_checkpoint(args.ckpt_dir, newest,
                                                    tmpl)
            convert.load_jax_tree(params, restored["params"])
            del opt_state            # freed before the restored one is made
            opt_state = convert.opt_state_from_jax(restored["opt"], params)
            del restored
            start_step = newest + 1
            print(f"[restore] resumed from step {newest}")

    data = SyntheticDataset(args.seed, args.batch, args.seq,
                            cfg.vocab_size, cfg.num_codebooks)
    step_fn = make_train_step(cfg, opt_cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    metrics = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1000:.0f}ms", flush=True)
        if ckpt and args.ckpt_dir and step % args.ckpt_every == 0 \
                and step > start_step:
            ckpt.submit(step, convert.train_state_to_jax_tree(
                params, opt_state), extra={"arch": args.arch})
    if ckpt:
        if metrics is not None:
            ckpt.submit(args.steps - 1,
                        convert.train_state_to_jax_tree(params, opt_state),
                        extra={"arch": args.arch})
        ckpt.close()
    if times:
        arr = np.asarray(times[1:]) if len(times) > 1 else np.asarray(times)
        print(f"[timing] median {np.median(arr)*1000:.0f}ms "
              f"p95 {np.percentile(arr, 95)*1000:.0f}ms "
              f"(straggler watermark)")
    if metrics is None:          # resumed past the end: nothing to do
        print("[restore] checkpoint already at final step")
        return float("nan")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
