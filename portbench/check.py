"""Whether the timed path was right: the program's answers to sampled
queries of the window held against the plain reference (``ref.py``).

* Min-combine apps (sssp, batched or not): every label of every
  sampled query must equal the reference's exact distance.  The number
  compared is ``label_mismatches``, the count of labels that differ
  over the sampled answers, with the limit 0.
* PageRank: ``rank_l1_gap``, the largest L1 distance over the sampled
  answers between the program's ranks and the float64 reference's, each
  run to its own stop (so a program that stops a round early or late
  reads as one round's change).

Each check is ``{"value": ..., "limit": ...}`` and holds when its value
is at most its limit.  The limits live in the traffic mix's ``limits``,
set from readings of sound runs and of the control (``control.py``), as
``PERF.md`` records.
"""
from __future__ import annotations

import torch

from . import ref, program


def reference(traffic: dict, csr, sources, dtype=None):
    """The reference's answer to one query: ``(labels, records)`` —
    labels ``[B, V]`` int32 and the round records for a min-combine app,
    ranks and each round's largest change for pagerank.  ``dtype`` holds
    the labels (ranks) in a lower precision: the control."""
    row_ptr, col_idx, edge_w = csr
    app = traffic["app"]
    if app == "pagerank":
        kw = {} if dtype is None else {"dtype": dtype,
                                       "acc_dtype": torch.float32}
        return ref.pagerank(row_ptr, col_idx, float(traffic["damping"]),
                            float(traffic["tol"]),
                            int(traffic["max_rounds"]), **kw)
    kw = {} if dtype is None else {"dtype": dtype}
    return ref.sssp(row_ptr, col_idx, edge_w, list(sources),
                    weighted=program.APPS[app][1], **kw)


def judge(traffic: dict, csr, answers) -> tuple:
    """``(checks, failed, records)`` for ``answers``, a list of
    ``(sources, labels, rounds)`` of the program (labels on any
    device): ``failed`` counts the answers that broke a limit,
    ``records`` holds the reference's records of each answer (for the
    work count).  Queries with the same sources share one reference
    run."""
    limits = traffic["limits"]
    name = "rank_l1_gap" if traffic["app"] == "pagerank" else \
        "label_mismatches"
    worst, failed, records, known = 0, 0, [], {}
    for sources, labels, _ in answers:
        key = tuple(sources)
        if key not in known:
            known[key] = reference(traffic, csr, sources)
        want, recs = known[key]
        labels = labels.to(want.device)
        if labels.numel() != want.numel():   # every value counts as wrong
            gap = want.numel()
        elif name == "rank_l1_gap":
            gap = float((labels.double().reshape(want.shape)
                         - want.double()).abs().sum())
        else:
            gap = int((labels.reshape(want.shape) != want).sum())
        del labels
        worst = max(worst, gap) if name == "rank_l1_gap" else worst + gap
        failed += gap > limits[name]
        records.append(recs)
    return {name: {"value": worst, "limit": limits[name]}}, failed, records


def holds(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
