"""GoFS — Graph-oriented File System (paper §V), counterpart of
``repro.gofs`` with the same on-disk format.

Slice-based storage for time-series graph collections: partitioned by
topology, subgraphs bin-packed into slices (§V-D), instances temporally
packed (§V-C), attributes projected into separate slices (§V-B), LRU
slice caching (§V-E).  ``GoFSStore`` implements the iBSP engine's
``InstanceProvider`` protocol — Gopher-on-GoFS, as co-designed in the
paper — and stages blocked batches for ``TemporalEngine``.

``gofs.prefetch.SlicePrefetcher`` stages streamed loads ahead of the
engine.  Not ported yet: appending to a deployed collection (ROADMAP
queue 1, item 5).
"""
from repro_torch.gofs.cache import SliceCache
from repro_torch.gofs.layout import deploy_collection
from repro_torch.gofs.store import GoFSStore

__all__ = ["SliceCache", "deploy_collection", "GoFSStore"]
