"""GoFS access API (paper §V-B): subgraph-centric iterators over a deployed
collection, with temporal filtering, attribute projection, value
inheritance, bin-major ordering, and transparent LRU slice caching.

Counterpart of ``repro.gofs.store``; it reads the same on-disk format.
``GoFSStore`` implements ``repro_torch.core.ibsp.InstanceProvider`` so the
host iBSP engine runs directly on GoFS, and ``load_blocked`` stages an
edge attribute into the blocked batches ``TemporalEngine`` runs on the
card (``load_blocked_stream``: chunk by chunk, behind a prefetcher).  The
API only touches slices of the local deployment root.  ``refresh``
observes an append made by another writer (``append_instances``) at one
manifest read.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocked import SparseBlocked, pow2_bucket
from repro_torch.core.graph import AttributeDef
from repro_torch.core.ibsp import InstanceProvider, SubgraphInstance
from repro_torch.core.subgraph import SubgraphTopology
from repro_torch.gofs.cache import SliceCache
from repro_torch.gofs.layout import (
    attr_slice_name, delta_slice_name, tile_map_name)
from repro_torch.gofs.slices import ReadStats, read_array_slice, read_json_slice


class GoFSStore(InstanceProvider):
    def __init__(
        self,
        root: str,
        *,
        cache_slots: int = 14,
        vertex_projection: Optional[Sequence[str]] = None,
        edge_projection: Optional[Sequence[str]] = None,
        time_range: Optional[Tuple[float, float]] = None,
    ):
        self.root = root
        self.stats = ReadStats()
        self.cache = SliceCache(cache_slots)
        self._time_range = time_range
        self.meta = read_json_slice(os.path.join(root, "collection.json"),
                                    self.stats)
        self.version = int(self.meta.get("version", 0))
        self.ipack = int(self.meta["instances_per_slice"])
        self._v_attrs = {a["name"]: AttributeDef(**a)
                         for a in self.meta["vertex_attrs"]}
        self._e_attrs = {a["name"]: AttributeDef(**a)
                         for a in self.meta["edge_attrs"]}
        self.vertex_projection = tuple(
            vertex_projection if vertex_projection is not None
            else self._v_attrs
        )
        self.edge_projection = tuple(
            edge_projection if edge_projection is not None else self._e_attrs
        )
        self._bind_timeline()

        # partition metadata + bin-major subgraph order (§V-D)
        self._part_meta: Dict[int, Any] = {}
        self._sg_home: Dict[int, Tuple[int, int]] = {}  # sgid -> (pid, bin)
        self._order: List[int] = []
        for p in range(int(self.meta["num_partitions"])):
            pm = read_json_slice(
                os.path.join(root, f"part_{p}", "meta.json"), self.stats
            )
            self._part_meta[p] = pm
            for b, bin_meta in enumerate(pm["bins"]):
                for sg in bin_meta["subgraphs"]:
                    g = int(sg["sgid"])
                    self._sg_home[g] = (p, b)
                    self._order.append(g)
        self._topo_cache: Dict[int, SubgraphTopology] = {}
        self._bin_offsets: Dict[Tuple[int, int], Dict[str, Dict[int, Tuple[int, int]]]] = {}

    def _bind_timeline(self) -> None:
        """(Re)derive the visible-instance map from the current manifest —
        the temporal filter (§V-B) applied to the collection's timeline."""
        ts = np.asarray(self.meta["timestamps"], np.float64)
        dur = np.asarray(self.meta["durations"], np.float64)
        if self._time_range is not None:
            lo, hi = self._time_range
            sel = np.nonzero((ts < hi) & (ts + dur > lo))[0]
        else:
            sel = np.arange(len(ts))
        self._t_map: List[int] = [int(i) for i in sel]
        self.timestamps = ts

    # ---------------- streaming ingestion ----------------------------------
    def refresh(self) -> bool:
        """Observe an in-place append: re-read the collection manifest and,
        on a version change, rebind the timeline and invalidate exactly the
        cache entries the append may have rewritten — the partial tail
        pack's value slices plus every tile-map / delta-pool metadata slice
        (their pinned payload pools would otherwise serve pre-append
        values forever).  Untouched slices stay resident; template and
        partition metadata never change across an append.

        Returns True iff the collection changed.  An unreadable manifest
        (e.g. mid-replace on a non-atomic filesystem) leaves the store at
        its current version."""
        try:
            meta = read_json_slice(
                os.path.join(self.root, "collection.json"), self.stats)
        except (OSError, ValueError):
            return False
        version = int(meta.get("version", 0))
        n_inst = int(meta["num_instances"])
        if (version == self.version
                and n_inst == int(self.meta["num_instances"])):
            return False
        old_n = int(self.meta["num_instances"])
        k_dirty = old_n // self.ipack  # tail pack rewritten by the append
        self.meta = meta
        self.version = version
        self._bind_timeline()

        def stale(key: str) -> bool:
            if key.startswith("tilemap/") or key.startswith("delta/"):
                return True
            name = key.partition("/")[2]
            if not name.startswith("attr_"):
                return False
            try:
                return int(name.rsplit("_t", 1)[1]) >= k_dirty
            except (IndexError, ValueError):
                return True  # unparseable attr key: drop, never serve stale

        self.cache.invalidate(stale)
        return True

    def append_instances(self, tsg_new) -> Dict:
        """Append new instances to this store's collection in place (see
        :func:`repro_torch.gofs.layout.append_instances`) and refresh this
        reader to the committed version."""
        from repro_torch.gofs.layout import append_instances as _append

        meta = _append(tsg_new, self.root)
        self.refresh()
        return meta

    # ---------------- InstanceProvider ------------------------------------
    def subgraph_ids(self) -> Sequence[int]:
        """Bin-major partition order — the paper's balanced iterator."""
        return list(self._order)

    def num_timesteps(self) -> int:
        return len(self._t_map)

    def get_instance(self, t_idx: int, sgid: int) -> SubgraphInstance:
        t_real = self._t_map[t_idx]
        topo = self.get_topology(sgid)
        p, b = self._sg_home[sgid]
        offs = self._offsets(p, b)
        k, r = divmod(t_real, self.ipack)

        vv: Dict[str, np.ndarray] = {}
        for name in self.vertex_projection:
            a = self._v_attrs[name]
            if a.constant is not None:
                vv[name] = np.full(topo.num_vertices, a.constant,
                                   np.dtype(a.dtype))
                continue
            sl = self._load(p, attr_slice_name("v", name, b, k))
            o0, o1 = offs["v"][sgid]
            vv[name] = sl["vals"][r, o0:o1]
        lev: Dict[str, np.ndarray] = {}
        rev: Dict[str, np.ndarray] = {}
        for name in self.edge_projection:
            a = self._e_attrs[name]
            if a.constant is not None:
                lev[name] = np.full(topo.num_local_edges, a.constant,
                                    np.dtype(a.dtype))
                rev[name] = np.full(len(topo.remote_src), a.constant,
                                    np.dtype(a.dtype))
                continue
            sl = self._load(p, attr_slice_name("e", name, b, k))
            lo0, lo1 = offs["le"][sgid]
            ro0, ro1 = offs["re"][sgid]
            lev[name] = sl["local"][r, lo0:lo1]
            rev[name] = sl["remote"][r, ro0:ro1]
        return SubgraphInstance(
            topology=topo,
            timestep=t_idx,
            timestamp=float(self.timestamps[t_real]),
            vertex_values=vv,
            local_edge_values=lev,
            remote_edge_values=rev,
        )

    # ---------------- topology / template access --------------------------
    def get_topology(self, sgid: int) -> SubgraphTopology:
        if sgid in self._topo_cache:
            return self._topo_cache[sgid]
        p, b = self._sg_home[sgid]
        sl = self._load(p, f"template_{b}")
        for sg in self._part_meta[p]["bins"][b]["subgraphs"]:
            g = int(sg["sgid"])
            if g in self._topo_cache:
                continue
            verts = sl[f"sg{g}_vertices"]
            topo = SubgraphTopology(
                sgid=g, pid=p,
                vertices=verts,
                local_src=sl[f"sg{g}_lsrc"],
                local_dst=sl[f"sg{g}_ldst"],
                local_edge_id=sl[f"sg{g}_leid"],
                remote_src=sl[f"sg{g}_rsrc"],
                remote_dst_vertex=sl[f"sg{g}_rdstv"],
                remote_dst_sgid=sl[f"sg{g}_rdstg"],
                remote_edge_id=sl[f"sg{g}_reid"],
                global_to_local={int(v): i for i, v in enumerate(verts)},
            )
            self._topo_cache[g] = topo
        return self._topo_cache[sgid]

    def iter_subgraphs(self, pid: Optional[int] = None) -> Iterator[SubgraphTopology]:
        """Space iterator: subgraphs in bin-major order (§V-D)."""
        for g in self._order:
            if pid is None or self._sg_home[g][0] == pid:
                yield self.get_topology(g)

    def iter_instances(self, sgid: int) -> Iterator[SubgraphInstance]:
        """Time iterator: a subgraph's instances in time order (§V-B)."""
        for t in range(self.num_timesteps()):
            yield self.get_instance(t, sgid)

    # ---------------- bulk staging (blocked engine path) -------------------
    def _visible_packs(
        self, t_indices: Optional[Sequence[int]] = None
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Visible timesteps grouped by time pack: {pack: [(row, offset)]}.

        ``t_indices``: subset of visible instance indices (default: all);
        ``row`` indexes into that subset."""
        if t_indices is None:
            t_indices = range(len(self._t_map))
        packs: Dict[int, List[Tuple[int, int]]] = {}
        for j, i in enumerate(t_indices):
            k, r = divmod(self._t_map[i], self.ipack)
            packs.setdefault(k, []).append((j, r))
        return packs

    def _bin_concat_ids(self, p: int, b: int, field: str) -> np.ndarray:
        """Template ids for a bin's concatenated value arrays, in slice
        order.  field: 'vertices' | 'local_edge_id' | 'remote_edge_id'."""
        sgs = [int(sg["sgid"]) for sg in self._part_meta[p]["bins"][b]["subgraphs"]]
        if not sgs:
            return np.array([], np.int64)
        return np.concatenate(
            [getattr(self.get_topology(g), field) for g in sgs]
        )

    def edge_attr_rows(
        self, name: str, t_indices: Sequence[int],
        parts: Optional[Sequence[int]] = None,
        fill: float = np.nan,
        halo: bool = False,
    ) -> np.ndarray:
        """Bulk-read an edge attribute for a subset of visible instances
        into template edge order: (len(t_indices), E) float32.

        One slice read per (partition, bin, pack) touched by the subset —
        the chunk grain of a streamed load.

        ``parts`` restricts the read to those partitions' slice files —
        the shard-local staging path of the cluster runtime: a process
        reads only the slices of partitions it owns, so its store byte
        traffic is ~its shard fraction of the collection.  Edge
        positions no selected partition references hold ``fill``.

        A partition's slice files record its *outgoing* cut edges (the
        deployment stores each cut edge with its SOURCE subgraph), but the
        consuming ``fill_boundary_batch(parts=...)`` scatters the cut
        edges *incoming* to the owned partitions — which live in the
        PEER partitions' remote arrays.  ``halo=True`` adds that halo
        read: for every non-selected partition, only the ``remote`` half
        of its slices is read (cut edges are the partitioner-minimized
        sliver of the collection), so a shard-local stage is complete
        without reading the peers' local-edge bulk."""
        a = self._e_attrs[name]
        n = len(t_indices)
        E = int(self.meta["num_edges"])
        if a.constant is not None:
            return np.full((n, E), a.constant, np.float32)
        if parts is None:
            parts = range(int(self.meta["num_partitions"]))
            halo = False  # full read: nothing left to halo
            out = np.empty((n, E), np.float32)
        else:
            out = np.full((n, E), fill, np.float32)
        packs = self._visible_packs(t_indices)
        for p in parts:
            for b in range(len(self._part_meta[p]["bins"])):
                le_ids = self._bin_concat_ids(p, b, "local_edge_id")
                re_ids = self._bin_concat_ids(p, b, "remote_edge_id")
                for k, rows in packs.items():
                    sl = self._load(p, attr_slice_name("e", name, b, k))
                    for j, r in rows:
                        out[j, le_ids] = sl["local"][r]
                        out[j, re_ids] = sl["remote"][r]
        if halo:
            owned = set(parts)
            for p in range(int(self.meta["num_partitions"])):
                if p in owned:
                    continue
                for b in range(len(self._part_meta[p]["bins"])):
                    re_ids = self._bin_concat_ids(p, b, "remote_edge_id")
                    if re_ids.size == 0:
                        continue
                    for k, rows in packs.items():
                        sl = self._load(p, attr_slice_name("e", name, b, k))
                        for j, r in rows:
                            out[j, re_ids] = sl["remote"][r]
        return out

    def edge_attr_matrix(self, name: str) -> np.ndarray:
        """Bulk-read an edge attribute for every visible instance into
        template edge order: (I, E) float32.

        One slice read per (partition, bin, pack) instead of one per
        (timestep, subgraph) — the staging path the temporal engine batches
        through ``BlockedGraph.fill_*_batch``.
        """
        return self.edge_attr_rows(name, range(self.num_timesteps()))

    def vertex_attr_matrix(self, name: str) -> np.ndarray:
        """Bulk-read a vertex attribute for every visible instance: (I, V)."""
        a = self._v_attrs[name]
        I = self.num_timesteps()
        V = int(self.meta["num_vertices"])
        dt = np.dtype(a.dtype)
        if a.constant is not None:
            return np.full((I, V), a.constant, dt)
        out = np.empty((I, V), dt)
        packs = self._visible_packs()
        for p in range(int(self.meta["num_partitions"])):
            for b in range(len(self._part_meta[p]["bins"])):
                v_ids = self._bin_concat_ids(p, b, "vertices")
                for k, rows in packs.items():
                    sl = self._load(p, attr_slice_name("v", name, b, k))
                    for i, r in rows:
                        out[i, v_ids] = sl["vals"][r]
        return out

    # -------------------------------------------------- sparse tile maps
    def edge_tile_maps(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        """The deployment-recorded per-pack nonzero-tile maps for an edge
        attribute (``repro_torch.gofs.layout`` ``sparse_absent=``), or ``None``
        when the deployment recorded none."""
        path = os.path.join(self.root, tile_map_name(name))
        if not os.path.exists(path + ".npz"):
            return None
        try:
            return self.cache.get(
                f"tilemap/{name}",
                lambda: read_array_slice(path, self.stats),
                pin=True,  # metadata-grade: survives the c0 (slots=0) config
            )
        except (OSError, ValueError, KeyError, EOFError):
            return None  # truncated/corrupt map: activity unknown, not fatal

    def _recorded_activity(
        self, bg, name: str, zero: float,
        t_indices: Sequence[int],
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Assemble (act_local (I, P, T), act_boundary (I, P, Tb)) for the
        visible-instance subset from the recorded per-pack maps.  Returns
        ``None`` when no map was recorded, the absent value differs from
        the requested semiring ``zero``, or the recorded blocked structure
        does not match the caller's ``bg`` (different partitioning, block
        size, or vertex order) — callers then fall back to scanning the
        staged values, which is always correct."""
        maps = self.edge_tile_maps(name)
        if maps is None:
            return None
        if float(maps["absent"]) != float(zero):
            return None
        if int(maps["block_size"]) != bg.block_size:
            return None
        if (maps["tiles_rc"].shape != bg.tiles_rc.shape
                or not np.array_equal(maps["tiles_rc"], bg.tiles_rc)
                or maps["btiles_rc"].shape != bg.btiles_rc.shape
                or not np.array_equal(maps["btiles_rc"], bg.btiles_rc)):
            return None
        n = len(t_indices)
        act_l = np.zeros((n, bg.n_parts, bg.t_max), bool)
        act_b = np.zeros((n, bg.n_parts, bg.tb_max), bool)
        for j, i in enumerate(t_indices):
            k, r = divmod(self._t_map[i], self.ipack)
            act_l[j] = maps[f"local_{k}"][r].astype(bool)
            act_b[j] = maps[f"boundary_{k}"][r].astype(bool)
        return act_l, act_b

    def tile_occupancy(
        self, bg, name: str, *, zero: float = np.inf
    ) -> Optional[float]:
        """Active-tile fraction of the visible collection for an edge
        attribute, computed from the deployment-recorded tile maps ALONE —
        no value slice is read, so a planner can price the sparse layout
        (the Gopher planner) before staging anything.

        Preference order: per-pack maps matching the caller's ``bg``
        (exact, respects a temporal filter); else the deployment-recorded
        collection-wide ``occupancy`` scalar (an estimate when the
        caller's blocked structure differs from the deployment's); else
        ``None`` — activity unknown without reading values."""
        acts = self._recorded_activity(
            bg, name, zero, range(self.num_timesteps())
        )
        if acts is None:
            maps = self.edge_tile_maps(name)
            if (maps is not None and "occupancy" in maps
                    and float(maps["absent"]) == float(zero)):
                return float(maps["occupancy"])
            return None
        act_l, act_b = acts
        denom = self.num_timesteps() * (
            int(bg.n_tiles.sum()) + int(bg.n_btiles.sum())
        )
        if denom == 0:
            return 0.0
        return float(int(act_l.sum()) + int(act_b.sum())) / denom

    def sparse_buckets(
        self, bg, name: str, *, zero: float = np.inf
    ) -> Optional[Tuple[int, int]]:
        """Pow2 (local, boundary) tile buckets for the visible collection,
        derived from the recorded tile maps ALONE — no value slice is
        read, so a stream can pin one staged shape before staging starts.
        ``None`` when no usable map is recorded."""
        acts = self._recorded_activity(
            bg, name, zero, range(self.num_timesteps())
        )
        if acts is None:
            return None
        act_l, act_b = acts
        lmax = int(act_l.sum(-1).max()) if act_l.size else 0
        bmax = int(act_b.sum(-1).max()) if act_b.size else 0
        return pow2_bucket(lmax), pow2_bucket(bmax)

    # -------------------------------------------------- delta tile chain
    def edge_delta_index(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        """The deployment-recorded delta tile chain for an edge attribute
        (``repro_torch.gofs.layout`` module docstring): deduplicated payload
        pools + per-instance payload references.  ``None`` when the
        deployment recorded none or the slice is unreadable (corrupt /
        truncated) — readers then fall back to the full value slices."""
        path = os.path.join(self.root, delta_slice_name(name))
        if not os.path.exists(path + ".npz"):
            return None
        try:
            # pinned: the payload pool IS the staging working set — one
            # decode feeds every chunk of every stream (c0 exempts it)
            return self.cache.get(
                f"delta/{name}",
                lambda: read_array_slice(path, self.stats), pin=True,
            )
        except (OSError, ValueError, KeyError, EOFError):
            return None

    def _delta_chain(
        self, bg, name: str, zero: float, t_indices: Sequence[int],
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Validated (ref_local, ref_boundary, payloads_local,
        payloads_boundary) for the visible-instance subset, or ``None``
        when the chain is absent, stale (recorded against a different
        blocked structure / absent value than the caller's), or corrupt
        (refs out of pool range, shape drift) — the same
        validate-or-fallback contract as ``_recorded_activity``."""
        d = self.edge_delta_index(name)
        if d is None:
            return None
        try:
            if float(d["absent"]) != float(zero):
                return None
            if int(d["block_size"]) != bg.block_size:
                return None
            if (d["tiles_rc"].shape != bg.tiles_rc.shape
                    or not np.array_equal(d["tiles_rc"], bg.tiles_rc)
                    or d["btiles_rc"].shape != bg.btiles_rc.shape
                    or not np.array_equal(d["btiles_rc"], bg.btiles_rc)):
                return None
            B = bg.block_size
            n_total = int(d["n_instances"])
            ref_l, ref_b = d["ref_local"], d["ref_boundary"]
            pay_l, pay_b = d["payloads_local"], d["payloads_boundary"]
            if ref_l.shape != (n_total, bg.n_parts, bg.t_max):
                return None
            if ref_b.shape != (n_total, bg.n_parts, bg.tb_max):
                return None
            if pay_l.ndim != 3 or pay_l.shape[1:] != (B, B):
                return None
            if pay_b.ndim != 3 or pay_b.shape[1:] != (B, B):
                return None
            if ref_l.size and int(ref_l.max()) >= len(pay_l):
                return None
            if ref_b.size and int(ref_b.max()) >= len(pay_b):
                return None
            idx = [self._t_map[i] for i in t_indices]
            if idx and max(idx) >= n_total:
                return None
            return (ref_l[idx].astype(np.int64), ref_b[idx].astype(np.int64),
                    np.asarray(pay_l, np.float32),
                    np.asarray(pay_b, np.float32))
        except (KeyError, ValueError, TypeError):
            return None

    def delta_stats(
        self, name: str, *, zero: Optional[float] = None
    ) -> Tuple[Optional[float], Optional[bool]]:
        """Deploy-recorded delta summary for an edge attribute, read from
        the tile-map METADATA slice alone (planning never opens the
        payload slice): (unique-payload / active-tile-instance ratio,
        monotone-nonincreasing flag).  (None, None) when not recorded or
        recorded against a different absent value than ``zero``."""
        maps = self.edge_tile_maps(name)
        if maps is None or "delta_unique_ratio" not in maps:
            return None, None
        if zero is not None and float(maps["absent"]) != float(zero):
            return None, None
        return (float(maps["delta_unique_ratio"]),
                bool(int(maps["delta_monotone"])))

    def _stage_delta(self, bg, zero: float, chain):
        """Packed batch reconstructed from a validated delta chain: each
        unique payload's bytes enter RAM once (from the pinned pool) and
        fan out by gather.  Bitwise-identical to the full sparse fill —
        the payloads were recorded from the same fill at deploy time and
        ``pack_tile_index`` assigns the same slots."""
        ref_l, ref_b, pay_l, pay_b = chain
        tiles, rows, cols, nnz = bg.pack_payload_tiles(
            ref_l, pay_l, bg.tiles_rc, zero)
        btiles, brows, bcols, bnnz = bg.pack_payload_tiles(
            ref_b, pay_b, bg.btiles_rc, zero)
        B2 = bg.block_size * bg.block_size
        uniq = (len(np.unique(ref_l[ref_l >= 0]))
                + len(np.unique(ref_b[ref_b >= 0])))
        src_bytes = int(uniq) * B2 * 4 + int(
            rows.nbytes + cols.nbytes + brows.nbytes + bcols.nbytes
        )
        return SparseBlocked(
            block_size=bg.block_size,
            tiles=tiles, btiles=btiles,
            rows=rows, cols=cols, brows=brows, bcols=bcols,
            nnz=nnz, bnnz=bnnz,
            total_tiles=int(bg.n_tiles.sum()),
            total_btiles=int(bg.n_btiles.sum()),
            source_bytes=src_bytes,
        )

    def load_blocked(
        self, bg, name: str, *, zero: float = np.inf, layout: str = "dense",
        delta: Optional[bool] = None,
    ):
        """Stage an edge attribute straight into blocked instance tensors.

        ``layout="dense"``: (tiles (I, P, T, B, B), btiles (I, P, Tb, B,
        B)) spanning every template tile slot.  ``layout="sparse"``: a
        packed :class:`~repro_torch.core.blocked.SparseBlocked` batch holding
        only each instance's active tiles; the deployment-recorded
        per-pack tile maps (``sparse_absent=`` at deploy time) skip the
        activity re-scan when they match ``bg`` and ``zero``.

        ``delta``: ``None``/``True`` reconstruct the sparse batch from the
        recorded delta tile chain when one validates against ``bg`` and
        ``zero`` (bitwise-identical, unique tile bytes decoded once,
        ``SparseBlocked.source_bytes`` reports the dedup); a stale or
        corrupt chain falls back to the full value slices.  ``False``
        never touches the chain."""
        if layout not in ("dense", "sparse"):
            raise ValueError(f"layout must be 'dense' or 'sparse', got "
                             f"{layout!r}")
        if layout == "sparse":
            if delta is not False:
                chain = self._delta_chain(
                    bg, name, zero, range(self.num_timesteps())
                )
                if chain is not None:
                    return self._stage_delta(bg, zero, chain)
            w = self.edge_attr_matrix(name)
            acts = self._recorded_activity(
                bg, name, zero, range(self.num_timesteps())
            )
            act_l, act_b = acts if acts is not None else (None, None)
            return bg.stage_sparse(
                w, zero=zero, act_local=act_l, act_boundary=act_b,
            )
        w = self.edge_attr_matrix(name)
        return bg.fill_local_batch(w, zero=zero), \
            bg.fill_boundary_batch(w, zero=zero)

    def load_blocked_stream(
        self,
        bg,
        name: str,
        *,
        zero: float = np.inf,
        prefetch_depth: int = 2,
        chunk_instances: Optional[int] = None,
        num_workers: int = 1,
        inflight: Optional[int] = None,
        layout: str = "dense",
        delta: Optional[bool] = None,
        transform=None,
    ):
        """Streaming variant of ``load_blocked``: a
        :class:`~repro_torch.gofs.prefetch.SlicePrefetcher` yielding
        instance chunks as their (bin, pack) slices land, so the engine
        can execute chunk *k* while chunk *k+1* stages
        (``TemporalEngine.run(..., stream=...)`` / ``staging="async"``).

        ``chunk_instances`` defaults to the deployment's temporal pack size
        (``instances_per_slice``) — the natural disk grain: one chunk reads
        each (partition, bin) attribute slice of one time pack exactly once.

        ``layout="sparse"`` stages packed active-tile chunks; when the
        deployment recorded tile maps for this attribute, the stream-wide
        pow2 bucket is pinned from the maps up front (one staged shape for
        the whole stream, no value read needed), else each chunk buckets
        itself.

        ``delta``: as in ``load_blocked`` — a validated delta tile chain
        makes each chunk a payload-pool reconstruction (unique tile bytes
        staged once per chunk, reported via ``StagedChunk.staged_bytes``)
        with no per-chunk value-slice reads; stale/corrupt chains fall
        back to the full read+fill path.  ``transform``: per-instance
        row-wise derived weights computed chunk-wise on the prefetch pool
        (see :class:`~repro_torch.gofs.prefetch.SlicePrefetcher`);
        transformed values bypass the delta chain and recorded buckets,
        which describe the RAW attribute.
        """
        from repro_torch.gofs.prefetch import SlicePrefetcher, StagedChunk

        if layout not in ("dense", "sparse"):
            raise ValueError(f"layout must be 'dense' or 'sparse', got "
                             f"{layout!r}")
        chunk = int(chunk_instances or self.ipack)
        if layout == "sparse" and delta is not False and transform is None:
            chain = self._delta_chain(
                bg, name, zero, range(self.num_timesteps())
            )
            if chain is not None:
                ref_l, ref_b, pay_l, pay_b = chain
                # stream-wide pow2 buckets straight from the refs: exact,
                # and identical to the bulk delta load's bucket choice
                lnnz = (ref_l >= 0).sum(-1)
                bnz = (ref_b >= 0).sum(-1)
                buck = pow2_bucket(int(lnnz.max()) if lnnz.size else 0)
                bbuck = pow2_bucket(int(bnz.max()) if bnz.size else 0)
                B2 = bg.block_size * bg.block_size

                def stage_delta_chunk(s: int, e: int, alloc) -> StagedChunk:
                    rl, rb = ref_l[s:e], ref_b[s:e]
                    out_l, out_b = alloc(e - s, buck, bbuck)
                    tiles, rows, cols, nnz = bg.pack_payload_tiles(
                        rl, pay_l, bg.tiles_rc, zero, bucket=buck,
                        out=out_l)
                    btiles, brows, bcols, bn = bg.pack_payload_tiles(
                        rb, pay_b, bg.btiles_rc, zero, bucket=bbuck,
                        out=out_b)
                    uniq = (len(np.unique(rl[rl >= 0]))
                            + len(np.unique(rb[rb >= 0])))
                    staged = int(uniq) * B2 * 4 + int(
                        rows.nbytes + cols.nbytes
                        + brows.nbytes + bcols.nbytes)
                    return StagedChunk(
                        start=s, count=e - s, tiles=tiles, btiles=btiles,
                        rows=rows, cols=cols, brows=brows, bcols=bcols,
                        nnz=nnz, bnnz=bn, staged_bytes=staged)

                return SlicePrefetcher(
                    bg, None, self.num_timesteps(), zero=zero,
                    prefetch_depth=prefetch_depth, chunk_instances=chunk,
                    num_workers=num_workers, inflight=inflight,
                    layout=layout, stage_fn=stage_delta_chunk,
                )
        bucket = bbucket = None
        if layout == "sparse" and transform is None:
            buckets = self.sparse_buckets(bg, name, zero=zero)
            if buckets is not None:
                bucket, bbucket = buckets
        return SlicePrefetcher(
            bg,
            lambda s, e: self.edge_attr_rows(name, range(s, e)),
            self.num_timesteps(),
            zero=zero,
            prefetch_depth=prefetch_depth,
            chunk_instances=chunk,
            num_workers=num_workers,
            inflight=inflight,
            layout=layout,
            bucket=bucket,
            bbucket=bbucket,
            transform=transform,
        )

    # ---------------- internals -------------------------------------------
    def _load(self, pid: int, slice_name: str) -> Dict[str, np.ndarray]:
        path = os.path.join(self.root, f"part_{pid}", slice_name)
        return self.cache.get(
            f"{pid}/{slice_name}", lambda: read_array_slice(path, self.stats)
        )

    def _offsets(self, p: int, b: int):
        """Start/end offsets of each subgraph inside the bin's concatenated
        vertex/edge value arrays."""
        key = (p, b)
        if key in self._bin_offsets:
            return self._bin_offsets[key]
        offs = {"v": {}, "le": {}, "re": {}}
        ov = ole = ore = 0
        for sg in self._part_meta[p]["bins"][b]["subgraphs"]:
            g = int(sg["sgid"])
            nv, nle, nre = (int(sg["n_vertices"]), int(sg["n_local_edges"]),
                            int(sg["n_remote_edges"]))
            offs["v"][g] = (ov, ov + nv)
            offs["le"][g] = (ole, ole + nle)
            offs["re"][g] = (ore, ore + nre)
            ov += nv
            ole += nle
            ore += nre
        self._bin_offsets[key] = offs
        return offs

    # ---------------- accounting -------------------------------------------
    def reset_stats(self) -> None:
        self.stats.reset()
        self.cache.hits = 0
        self.cache.misses = 0

    def snapshot_stats(self) -> Dict[str, float]:
        return {**self.stats.snapshot(), **self.cache.stats()}
