"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the
window (reset once set-up ends), in GiB: the graph, the program's
captured traversal and its per-query tensors, and the few answers the
check holds."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
