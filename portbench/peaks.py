"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  NVIDIA's data sheet for the
H100 SXM (dense rates, the full 700 W power limit); a card set to a
lower limit runs below them, so ``run.py`` reports the limit beside
every result."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(device_name: str, key: str):
    """The named peak of ``device_name``, or None for a card the table
    does not hold (a reader then reports nothing rather than a share of
    a guessed peak)."""
    return PEAKS.get(device_name, {}).get(key)
