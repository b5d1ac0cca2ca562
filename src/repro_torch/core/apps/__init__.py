"""Application drivers of the port (host-mode bfs and sssp so far)."""
from .drivers import (bfs, sssp, bfs_batch, sssp_batch, AppResult,
                      relax_round)

__all__ = ["bfs", "sssp", "bfs_batch", "sssp_batch", "AppResult",
           "relax_round"]
