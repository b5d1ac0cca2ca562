from .pipeline import synthetic_batch, SyntheticDataset

__all__ = ["synthetic_batch", "SyntheticDataset"]
