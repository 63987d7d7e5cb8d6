"""The analytic cost model of the boundary exchange, counterpart of the
numpy half of ``repro.dist.collectives``.

:func:`boundary_exchange_bytes` derives the per-superstep bytes of one
boundary exchange from (num_boundary, devices, backend), so the planner
can price the comm backend before anything runs — even when the
partitions are stacked on one device.  The reference's HLO collective
parser has no counterpart here (ROADMAP item 11).
"""
from __future__ import annotations

from typing import Dict


def boundary_exchange_bytes(
    num_boundary: int,
    n_devices: int,
    backend: str = "dense",
    *,
    dtype_bytes: int = 4,
    boundary_nnz: int | None = None,
) -> Dict[str, float]:
    """Analytic per-superstep comm cost of one boundary exchange.

    ``boundary_nnz`` — the boundary vertices actually published
    (``BlockedGraph.boundary_nnz``), as opposed to the block-padded
    ``num_boundary`` buffer length.  When given it replaces
    ``num_boundary`` in the byte model: that is the payload a
    sparse-aware exchange moves, and the quantity backend selection
    should reason about (a padded buffer can overstate a tiny cut by a
    whole block).

    Returns ``{"kind", "hops", "bytes_per_device", "bytes_total"}`` for a
    (num_boundary,)-float buffer combined across ``n_devices`` partitions:

    * ``dense`` — a ring all-reduce moves ``2 (n-1)/n × NB`` bytes per
      device (reduce-scatter + all-gather), in ``2 (n-1)`` latency hops.
    * ``ring``  — the circulate-and-fold ring sends the full NB
      buffer on ``n-1`` hops per device: MORE total bytes than the dense
      all-reduce, but every transfer is strictly neighbor-to-neighbor, so
      on a bandwidth-asymmetric topology (multi-pod DCI) each slow link
      carries exactly one NB buffer per hop instead of the all-reduce
      tree's cross-section traffic — latency-bound small cuts prefer
      ``dense``, DCI-bandwidth-bound large cuts prefer ``ring``.
    * ``ring-rs`` — the v2 ring: chunked reduce-scatter + all-gather over
      the same neighbor-to-neighbor ring.  Each hop moves an
      NB/n chunk instead of the full buffer, so per-device bytes drop to
      the bandwidth-optimal ``2 (n-1)/n × NB`` (same volume as the dense
      all-reduce) while KEEPING the strictly point-to-point transfer
      pattern — at ``2 (n-1)`` latency hops, double the circulate ring.
      Wins when the DCI cut is so large that ring traffic itself is
      bandwidth-bound.
    * ``host``  — no device collective: every partition ships its NB
      buffer to the host, which returns one combined buffer (``n × NB``
      up, ``n × NB`` down across PCIe/Ethernet, 2 logical hops).

    >>> boundary_exchange_bytes(1000, 4, "dense")["bytes_per_device"]
    6000.0
    >>> boundary_exchange_bytes(1000, 4, "ring")["hops"]
    3
    >>> boundary_exchange_bytes(1000, 4, "ring-rs")["bytes_per_device"]
    6000.0
    >>> boundary_exchange_bytes(1000, 4, "ring-rs")["hops"]
    6
    >>> boundary_exchange_bytes(1000, 4, "host")["kind"]
    'host-gather'
    >>> boundary_exchange_bytes(1024, 4, "dense",  # padded NB overstates
    ...                         boundary_nnz=37)["bytes_per_device"]
    222.0
    """
    if backend not in ("dense", "ring", "ring-rs", "host"):
        raise ValueError(f"unknown comm backend {backend!r}")
    eff = num_boundary if boundary_nnz is None else boundary_nnz
    nb = float(eff * dtype_bytes)
    n = int(n_devices)
    if backend == "dense":
        per_dev = 2.0 * (n - 1) / max(n, 1) * nb
        return {"kind": "all-reduce", "hops": 2 * (n - 1),
                "bytes_per_device": per_dev, "bytes_total": per_dev * n}
    if backend == "ring":
        per_dev = (n - 1) * nb
        return {"kind": "collective-permute", "hops": n - 1,
                "bytes_per_device": per_dev, "bytes_total": per_dev * n}
    if backend == "ring-rs":
        per_dev = 2.0 * (n - 1) / max(n, 1) * nb
        return {"kind": "collective-permute", "hops": 2 * (n - 1),
                "bytes_per_device": per_dev, "bytes_total": per_dev * n}
    return {"kind": "host-gather", "hops": 2,
            "bytes_per_device": 2.0 * nb, "bytes_total": 2.0 * nb * n}
