"""Multi-process GoFFish cluster runtime (paper §V deployment shape),
counterpart of ``repro.cluster``.

The paper's GoFFish runs on a commodity cluster: every worker hosts its
own GoFS partition slices and Gopher computes where the data lives.  This
package is that deployment layer for the blocked engine:

* :mod:`repro_torch.cluster.runtime` — process bootstrap
  (``torch.distributed`` with ``gloo`` when asked, single-process no-op
  fallback) plus the rank-ordered TCP exchange every cross-process
  primitive rides on.
* :mod:`repro_torch.cluster.staging` — shard-local staging: each
  process's :class:`~repro_torch.gofs.prefetch.SlicePrefetcher` stages
  only its OWN partition shard of the collection (~1/num_processes of
  the bytes), with a cross-process consistency check on chunk
  boundaries.
* :mod:`repro_torch.cluster.gather` — :class:`ClusterGather`, the real
  inter-process boundary exchange behind the ``_host_fold_*`` seam of
  ``repro_torch.core.comm`` (bitwise-identical to the single-process
  fold).
* :mod:`repro_torch.cluster.checkpoint` — periodic snapshots of long
  analytic runs (atomic-rename helpers of ``repro_torch.train
  .checkpoint``) so a preempted worker resumes mid-collection
  bitwise-identically.

Several processes may share one card: each holds its own CUDA context,
runs the graph kernels over its own partition range, and exchanges on
the host.
"""
from repro_torch.cluster.checkpoint import AnalyticCheckpointer, ResumableRun
from repro_torch.cluster.gather import ClusterGather
from repro_torch.cluster.runtime import ClusterRuntime, init_cluster
from repro_torch.cluster.staging import shard_staged_bytes, shard_stream

__all__ = [
    "AnalyticCheckpointer",
    "ClusterGather",
    "ClusterRuntime",
    "ResumableRun",
    "init_cluster",
    "shard_staged_bytes",
    "shard_stream",
]
