"""Application drivers of the port (host, spmd and fused modes): the
paper's five apps, batched point queries and the resumable min-combine
loop."""
from .drivers import (bfs, sssp, bfs_batch, sssp_batch, cc, kcore,
                      pagerank, resume_loop, step_batch, QUERY_APPS,
                      AppResult, relax_round)

__all__ = ["bfs", "sssp", "bfs_batch", "sssp_batch", "cc", "kcore",
           "pagerank", "resume_loop", "step_batch", "QUERY_APPS",
           "AppResult", "relax_round"]
