"""The least time a nearest-neighbour kernel call could take on the card:
the bytes the call needs, at the card's memory bandwidth.

A call needs each input byte read once and each output byte written once.
An exact NN search has no fixed operation count (the pairs a kernel
evaluates move with its algorithm, and an all-pairs count would put a
kernel that prunes better above 100%), so there is no operation bound:
the bound reads the same work whatever implements it.

- K1 (``csrc/nn1.cu``, 1-NN): ``n`` queries of 3 float32 read, the live
  targets' 3 float32 and their mask byte read, an int32 index and a
  float32 d² written per query.
- K2 (``csrc/knn.cu``, k-NN): the same reads, ``k`` int32 indices and
  ``k`` float32 d² written per query.

``n`` is the call's query rows (the call has no query mask: every row
gets an answer); the live targets are those its mask holds.
"""

from __future__ import annotations

# NVIDIA H100 SXM, HBM3 (NVIDIA's data sheet), at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(n_query: int, m_live: int) -> int:
    return 12 * n_query + 13 * m_live + 8 * n_query


def k2_bytes(n_query: int, m_live: int, k: int) -> int:
    return 12 * n_query + 13 * m_live + 8 * k * n_query


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def share_pct(bound_s: float, device_s: float):
    """100 × bound over device time; None when the kernel did not run."""
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
