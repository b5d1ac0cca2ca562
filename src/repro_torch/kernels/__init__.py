"""Hand-written Hopper kernels of the port and their plain versions.

* ``relax.twc_bin_relax``       — ``csrc/twc_relax.cu`` (CUDA C++), one
  degree bin's ALB pass fused: slot -> edge, gather, ``msg``, atomic
  combine into the labels;
* ``relax.edge_lb_relax``       — ``csrc/edge_lb_relax.cu`` (CUDA C++),
  the huge bin's edge-balanced ALB pass fused the same way;
* ``relax.merge_path_relax``    — ``csrc/merge_path_relax.cu`` (CUDA
  C++), the merge-path pass over every frontier edge fused the same way
  (the tile walk ``csrc/tile_relax.cuh`` is ``edge_lb_relax``'s too);
* ``relax.twc_bin_list``        — ``csrc/twc_list.cu`` (CUDA C++), no TPU
  kernel: the static round's frontier inspector, each degree bin's
  members listed once a round from the dense frontier and ``row_ptr``,
  in vertex order, for ``twc_bin_relax``, and the LB bin's for
  ``edge_lb_relax`` / ``merge_path_relax``;
* ``relax.round_turn``          — ``csrc/round_turn.cu`` (CUDA C++), no
  TPU kernel: the fused min-combine loop's turn, the next frontier, the
  carry's labels brought level with the round's relaxed copy and the
  next round's census (``n_f``, ``m_f``), in one pass;
* ``twc_gather.twc_bin_map``    — ``csrc/twc_gather.cu`` (CUDA C++), the
  index map of a degree bin (the Pallas kernel's counterpart);
* ``edge_lb.edge_lb_map``       — ``csrc/edge_lb.cu`` (CUDA C++), the
  huge bin's index map (the Pallas kernel's counterpart);
* ``merge_path.merge_path_map`` — ``csrc/merge_path.cu`` (CUDA C++), the
  merge-path index map (the Pallas kernel's counterpart);
* ``moe_plan.moe_plan``          — ``csrc/moe_plan.cu`` (CUDA C++), the
  whole MoE dispatch plan of a layer (top-k, gates, arrival ranks, ALB
  rebalance, keep) in one launch, one thread block cluster per group;
* ``moe_dispatch.positions_in_expert`` — ``csrc/moe_dispatch.cu``
  (CUDA C++), the arrival ranks alone (the Pallas kernel's counterpart;
  off the main path since ``moe_plan``);
* ``flash_attention.flash_attention`` — the prefill attention of the LM
  serving path, two CUDA C++ kernels chosen by ``flash_attention.route``:
  ``csrc/flash_attention_wgmma.cu`` (bf16, head width 64, 80, 128 or
  256: TMA and ``wgmma``) and ``csrc/flash_attention.cu`` (float32 and
  other head widths: CUDA cores);
* ``csrc/graph_loop.cu``        — no TPU kernel: the conditional graph
  nodes (IF, WHILE) and their condition kernel, for
  ``core.graph_loop``'s device control flow;
* ``ref``                       — plain PyTorch versions of all eleven;
* ``ops``                       — the executor pairs of
  ``core.balancer``: the fused relax kernels (or, for an operator they
  do not take, the index maps with the torch epilogue, counted in
  ``ops.unfused_passes``);
* ``build``                     — ``nvcc`` + ``ctypes``, on first use.

Each wrapper keeps a plain-integer launch counter (``fn.launches``),
incremented only where it launches its kernel; ``flash_attention`` also
counts each route (``fn.launches_by_route``), ``moe_plan`` each cluster
size (``fn.launches_by_cluster``).  The graph kernels' wrappers count a
call made while a CUDA graph is being captured in ``fn.captured``
instead: the graph launches the kernel, as often as it runs, so the
kernels of the static-shape round (``DEVICE_COUNTED``) count their
launches on the card (:func:`device_launch_counts`).
"""
from __future__ import annotations

from . import flash_attention as _flash   # the modules keep their names
from . import moe_plan as _moe_plan
from . import ops as _ops
from .edge_lb import edge_lb_map
from .merge_path import merge_path_map
from .moe_dispatch import positions_in_expert
from .relax import (edge_lb_relax, merge_path_relax, round_turn,
                    twc_bin_list, twc_bin_relax)
from .twc_gather import twc_bin_map

KERNELS = {"twc_bin_relax": twc_bin_relax, "edge_lb_relax": edge_lb_relax,
           "merge_path_relax": merge_path_relax,
           "twc_bin_list": twc_bin_list, "round_turn": round_turn,
           "twc_bin_map": twc_bin_map, "edge_lb_map": edge_lb_map,
           "merge_path_map": merge_path_map,
           "moe_plan": _moe_plan.moe_plan,
           "positions_in_expert": positions_in_expert,
           "flash_attention": _flash.flash_attention}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


#: kernels that count their own launches on the card, by source
DEVICE_COUNTED = {"twc_bin_relax": "twc_relax",
                  "edge_lb_relax": "edge_lb_relax",
                  "merge_path_relax": "merge_path_relax",
                  "twc_bin_list": "twc_list",
                  "merge_path_map": "merge_path",
                  "round_turn": "round_turn"}


def capture_counts() -> dict:
    """Calls of each graph kernel's wrapper recorded into a CUDA graph
    since the last :func:`reset_launch_counts`."""
    return {name: fn.captured for name, fn in KERNELS.items()
            if hasattr(fn, "captured")}


def device_launch_counts(reset: bool = False) -> dict:
    """Launches of each ``DEVICE_COUNTED`` kernel counted on the card
    (graph replays and WHILE turns included) since the last reset (CUDA
    only; reads the card, so it syncs)."""
    from . import build
    return {name: build.device_launches(src, reset)
            for name, src in DEVICE_COUNTED.items()}


def reset_launch_counts() -> None:
    """Zero every launch counter (``launches``, ``captured``, the
    per-route and per-cluster counts), and ``ops.unfused_passes``; the
    device counts are reset by :func:`device_launch_counts`."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "captured"):
            fn.captured = 0
        for by in ("launches_by_route", "launches_by_cluster"):
            counts = getattr(fn, by, {})
            for r in counts:
                counts[r] = 0
    _ops.unfused_passes = 0
