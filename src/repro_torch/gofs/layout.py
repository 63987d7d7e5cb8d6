"""GoFS on-disk layout: deployment-time packing (paper §V-A..D).

Counterpart of ``repro.gofs.layout``, writing the same format: a
deployment written by either package loads in the other.

Directory structure (one collection)::

    <root>/collection.json                     global metadata slice
    <root>/part_<p>/template_<b>.npz           topology slice per bin
    <root>/part_<p>/meta.json                  partition metadata slice
    <root>/part_<p>/attr_<kind>_<name>_b<b>_t<k>.npz
                                               attribute slice: one attribute
                                               x one subgraph bin x one time
                                               pack of ``instances_per_slice``

Deployment-time knobs (fixed at write time, as the paper requires):
``bins_per_partition`` (s20/s40 §V-D) and ``instances_per_slice`` (i1/i20
§V-C).  Constant attributes are stored once in the collection metadata and
never per instance; default-valued attributes inherit the template default
wherever an instance holds no value (§V-B value inheritance).

Block-sparse tile maps (``sparse_absent=``): for each named edge
attribute, deployment additionally records one ``tilemap_<attr>.npz``
slice at the collection root holding the PER-PACK nonzero-tile maps —
which (partition, tile) blocks of the blocked layout
(``repro_torch.core.blocked.build_blocked`` on this collection's
partitioning) contain at least one edge whose value differs from the
declared *absent* value in that instance.  ``GoFSStore.load_blocked(...,
layout="sparse")`` consumes these maps to emit packed
:class:`~repro_torch.core.blocked.SparseBlocked` batches without
re-scanning the values.

Delta tile chain (written alongside the tile maps): consecutive instances
of a slowly varying collection share most of their packed tile
*contents*.  Deployment deduplicates every active (instance, partition,
tile) block by its exact float32 bytes into a payload pool and stores one
``delta_<attr>.npz`` slice at the root: ``payloads_local`` /
``payloads_boundary`` (U, B, B) unique tile values plus ``ref_local``
(I, P, T) / ``ref_boundary`` (I, P, Tb) int32 maps from each active
template-tile slot to its payload id (-1 = inactive), payload ids in
order of first appearance.  Two summary scalars ride in the
(metadata-sized) ``tilemap_<attr>.npz``: ``delta_unique_ratio`` (unique
payloads / active tile-instances) and ``delta_monotone`` (1 iff every
instance's values are elementwise <= the previous instance's).

Streaming ingestion (``append_instances``, ``deploy_collection(
append=True)``) grows a deployed collection in place: the tail pack is
rewritten with its old rows kept, new packs are added, and the tile maps
and delta chain are extended (new tiles interning against the recorded
payload ids); the manifest's ``version`` is bumped last.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.core.blocked import build_blocked
from repro_torch.core.graph import TimeSeriesGraph
from repro_torch.core.partition import (
    bin_pack_subgraphs,
    discover_subgraphs,
    partition_graph,
)
from repro_torch.core.subgraph import build_subgraphs
from repro_torch.gofs.slices import (
    read_array_slice, read_json_slice, write_array_slice, write_json_slice)


def attr_slice_name(kind: str, attr: str, b: int, pack: int) -> str:
    return f"attr_{kind}_{attr}_b{b}_t{pack}"


def tile_map_name(attr: str) -> str:
    return f"tilemap_{attr}"


def delta_slice_name(attr: str) -> str:
    return f"delta_{attr}"


class _TilePool:
    """Exact-bytes deduplication of (B, B) float32 tiles into a payload
    pool: two tiles share a payload iff their bytes are identical, and ids
    follow first appearance.

    Tiles are keyed by a digest of their bytes and compared in full on a
    digest hit, so the pool holds each unique tile once (no byte-string
    keys) and copies it out of the caller's fill, which can then be freed.
    ``capacity`` bounds the count of new unique tiles (the active tiles to
    intern); pages of the buffer past that count are never touched.

    ``base`` rehydrates a recorded pool (U, B, B) so appended tiles intern
    against the same payload ids: its rows are indexed in place as views
    (ids 0..U-1, the first of two equal rows answering), and new tiles
    take ids from U on."""

    def __init__(self, capacity: int, block_size: int,
                 base: Optional[np.ndarray] = None):
        B = block_size
        self._buf = np.empty((max(1, capacity), B, B), np.float32)
        self._n = 0
        self._ids: Dict[bytes, List[int]] = {}
        self._base = (np.zeros((0, B, B), np.float32) if base is None
                      else np.ascontiguousarray(base, np.float32))
        for pid, tile in enumerate(self._base):
            self._ids.setdefault(self._key(tile), []).append(pid)

    @staticmethod
    def _key(tile: np.ndarray) -> bytes:
        return hashlib.blake2b(tile, digest_size=16).digest()

    def _row(self, pid: int) -> np.ndarray:
        nb = len(self._base)
        return self._base[pid] if pid < nb else self._buf[pid - nb]

    def intern(self, tile: np.ndarray) -> int:
        tile = np.ascontiguousarray(tile, np.float32)
        bits = tile.view(np.uint32)
        ids = self._ids.setdefault(self._key(tile), [])
        for pid in ids:
            if np.array_equal(self._row(pid).view(np.uint32), bits):
                return pid
        pid = len(self._base) + self._n
        self._buf[self._n] = tile
        self._n += 1
        ids.append(pid)
        return pid

    def __len__(self) -> int:
        return len(self._base) + self._n

    def parts(self) -> List[np.ndarray]:
        """The (U, B, B) unique tiles in id order, as the parts
        ``write_array_slice`` writes without joining them: the recorded
        pool, then the new tiles."""
        return [self._base, self._buf[: self._n]]


def _intern_tiles(vals: np.ndarray, act: np.ndarray, pool: _TilePool,
                  ref_out: np.ndarray) -> None:
    """Intern the active tiles of one instance's dense fill (P, T, B, B)
    (mask ``act`` (P, T)) into ``pool``, writing payload ids into
    ``ref_out`` (P, T) in place, in (partition, tile) order."""
    for p, t in zip(*map(np.ndarray.tolist, np.nonzero(act))):
        ref_out[p, t] = pool.intern(vals[p, t])


def _write_tile_maps(
    tsg: TimeSeriesGraph,
    cfg: GraphConfig,
    root: str,
    assign: np.ndarray,
    sparse_absent: Dict[str, float],
    n_packs: int,
    ipack: int,
) -> None:
    """Record per-pack nonzero-tile maps for the named edge attributes.

    One ``tilemap_<attr>.npz`` at the collection root per attribute: the
    blocked tile index fingerprint (``tiles_rc``/``btiles_rc`` +
    ``block_size``, so a reader can verify its ``BlockedGraph`` matches
    the deployment's) plus, per time pack *k*, ``local_k``
    (rows, P, T) and ``boundary_k`` (rows, P, Tb) uint8 active-tile maps
    relative to the attribute's declared absent value.

    Alongside each tile map, one ``delta_<attr>.npz`` payload slice
    records the deduplicated tile chain (module docstring).  Instances
    are filled and interned one at a time, so the host holds one
    instance's dense tiles besides the unique payloads."""
    tmpl = tsg.template
    bg = build_blocked(tmpl, assign, cfg.block_size)
    n_inst = len(tsg)
    B = int(bg.block_size)
    n_valid = int(bg.n_tiles.sum()) + int(bg.n_btiles.sum())
    for name, absent in sparse_absent.items():
        tmpl.edge_attr(name)  # KeyError on unknown attribute
        zero = float(absent)
        arrs: Dict[str, np.ndarray] = {
            "tiles_rc": bg.tiles_rc,
            "btiles_rc": bg.btiles_rc,
            "block_size": np.asarray(bg.block_size, np.int64),
            "absent": np.asarray(absent, np.float64),
            "n_packs": np.asarray(n_packs, np.int64),
        }
        acts = []
        for k in range(n_packs):
            t0, t1 = k * ipack, min((k + 1) * ipack, n_inst)
            w = np.stack([tsg.edge_values(t, name) for t in range(t0, t1)])
            act_l, act_b = bg.active_tile_maps(w, zero=zero)
            arrs[f"local_{k}"] = act_l.astype(np.uint8)
            arrs[f"boundary_{k}"] = act_b.astype(np.uint8)
            acts.append((act_l, act_b))
        n_act_l = sum(int(a.sum()) for a, _ in acts)
        n_act_b = sum(int(b.sum()) for _, b in acts)
        n_active = n_act_l + n_act_b
        # ---- delta chain: dedup active tile contents across time ---------
        pool_l, pool_b = _TilePool(n_act_l, B), _TilePool(n_act_b, B)
        ref_l = np.full((n_inst, bg.n_parts, bg.t_max), -1, np.int32)
        ref_b = np.full((n_inst, bg.n_parts, bg.tb_max), -1, np.int32)
        monotone = True
        prev_w: Optional[np.ndarray] = None
        for t in range(n_inst):
            k, r = divmod(t, ipack)
            act_l, act_b = acts[k]
            wt = np.asarray(tsg.edge_values(t, name), np.float32)[None]
            _intern_tiles(bg.fill_local_batch(wt, zero=zero)[0], act_l[r],
                          pool_l, ref_l[t])
            _intern_tiles(bg.fill_boundary_batch(wt, zero=zero)[0],
                          act_b[r], pool_b, ref_b[t])
            if prev_w is not None:
                monotone = monotone and bool(np.all(wt[0] <= prev_w))
            prev_w = wt[0]
        # collection-wide active-tile fraction: a planner can price the
        # sparse layout from this scalar without touching a value slice,
        # even when its own BlockedGraph differs from the deployment's
        arrs["occupancy"] = np.asarray(
            n_active / max(1, n_inst * n_valid), np.float64
        )
        # delta summary scalars (payloads stay in the separate delta
        # slice so planning never pays the value bytes)
        arrs["delta_unique_ratio"] = np.asarray(
            (len(pool_l) + len(pool_b)) / max(1, n_active), np.float64
        )
        arrs["delta_monotone"] = np.asarray(int(monotone), np.int64)
        write_array_slice(os.path.join(root, tile_map_name(name)), arrs)
        write_array_slice(
            os.path.join(root, delta_slice_name(name)),
            {
                "tiles_rc": bg.tiles_rc,
                "btiles_rc": bg.btiles_rc,
                "block_size": np.asarray(bg.block_size, np.int64),
                "absent": np.asarray(absent, np.float64),
                "n_instances": np.asarray(n_inst, np.int64),
                "payloads_local": pool_l.parts(),
                "payloads_boundary": pool_b.parts(),
                "ref_local": ref_l,
                "ref_boundary": ref_b,
            },
        )


def deploy_collection(
    tsg: TimeSeriesGraph,
    cfg: GraphConfig,
    root: str,
    *,
    assign: Optional[np.ndarray] = None,
    sparse_absent: Optional[Dict[str, float]] = None,
    append: bool = False,
) -> Dict:
    """Partition, bin-pack, time-pack, and write the collection to disk.

    ``sparse_absent``: {edge attribute -> absent value} — for each entry a
    per-pack nonzero-tile map slice and a delta tile chain are recorded at
    the root (see module docstring), enabling the store's block-sparse
    and delta staging paths.

    ``append=True``: ``root`` must already hold a deployed collection and
    ``tsg`` holds ONLY the new instances — delegates to
    :func:`append_instances` (partitioning, binning, and sparse/delta
    recording are inherited from the existing deployment; ``cfg``,
    ``assign`` and ``sparse_absent`` are ignored).

    Returns the global metadata dict (also written to collection.json).
    """
    if append:
        return append_instances(tsg, root)
    tmpl = tsg.template
    if assign is None:
        assign = partition_graph(tmpl, cfg.num_partitions, seed=cfg.seed)
    sg_ids = discover_subgraphs(tmpl, assign)
    subgraphs = build_subgraphs(tmpl, assign, sg_ids)
    n_inst = len(tsg)
    ipack = max(1, cfg.instances_per_slice)
    n_packs = -(-n_inst // ipack)

    # group subgraphs per partition, bin-pack by vertex count (§V-D)
    by_part: Dict[int, List[int]] = {}
    for g, topo in subgraphs.items():
        by_part.setdefault(topo.pid, []).append(g)
    global_meta = {
        "name": tmpl.name,
        "num_vertices": int(tmpl.num_vertices),
        "num_edges": int(tmpl.num_edges),
        "num_instances": n_inst,
        "num_partitions": int(cfg.num_partitions),
        "instances_per_slice": ipack,
        "bins_per_partition": int(cfg.bins_per_partition),
        "timestamps": [float(g.timestamp) for g in tsg.instances],
        "durations": [float(g.duration) for g in tsg.instances],
        "vertex_attrs": [
            {"name": a.name, "dtype": a.dtype, "default": a.default,
             "constant": a.constant} for a in tmpl.vertex_attrs
        ],
        "edge_attrs": [
            {"name": a.name, "dtype": a.dtype, "default": a.default,
             "constant": a.constant} for a in tmpl.edge_attrs
        ],
        "partitions": {},
        # manifest version, bumped by every append, so a live reader can
        # detect growth with one metadata read
        "version": 0,
    }

    for p in range(cfg.num_partitions):
        gids = sorted(by_part.get(p, []))
        sizes = np.array([subgraphs[g].num_vertices for g in gids], np.int64)
        ids = np.array(gids, np.int64)
        n_bins = min(cfg.bins_per_partition, max(1, len(gids)))
        bins = bin_pack_subgraphs(sizes, ids, n_bins) if len(gids) else []
        pdir = os.path.join(root, f"part_{p}")
        part_meta = {"pid": p, "bins": [], "n_bins": len(bins)}

        for b, bin_gids in enumerate(bins):
            # ---- template slice: topology of this bin's subgraphs --------
            tarrs: Dict[str, np.ndarray] = {}
            bin_meta = {"subgraphs": [], "bin": b}
            for g in bin_gids.tolist():
                topo = subgraphs[g]
                tarrs[f"sg{g}_vertices"] = topo.vertices
                tarrs[f"sg{g}_lsrc"] = topo.local_src
                tarrs[f"sg{g}_ldst"] = topo.local_dst
                tarrs[f"sg{g}_leid"] = topo.local_edge_id
                tarrs[f"sg{g}_rsrc"] = topo.remote_src
                tarrs[f"sg{g}_rdstv"] = topo.remote_dst_vertex
                tarrs[f"sg{g}_rdstg"] = topo.remote_dst_sgid
                tarrs[f"sg{g}_reid"] = topo.remote_edge_id
                bin_meta["subgraphs"].append(
                    {"sgid": int(g), "n_vertices": int(topo.num_vertices),
                     "n_local_edges": int(topo.num_local_edges),
                     "n_remote_edges": int(len(topo.remote_src))}
                )
            write_array_slice(os.path.join(pdir, f"template_{b}"), tarrs)
            part_meta["bins"].append(bin_meta)

            # ---- attribute slices: kind x attr x time pack ---------------
            # concatenated vertex / edge index spaces for the whole bin
            v_cat = np.concatenate(
                [subgraphs[g].vertices for g in bin_gids.tolist()]
            ) if len(bin_gids) else np.array([], np.int64)
            le_cat = np.concatenate(
                [subgraphs[g].local_edge_id for g in bin_gids.tolist()]
            ) if len(bin_gids) else np.array([], np.int64)
            re_cat = np.concatenate(
                [subgraphs[g].remote_edge_id for g in bin_gids.tolist()]
            ) if len(bin_gids) else np.array([], np.int64)

            for a in tmpl.vertex_attrs:
                if a.constant is not None:
                    continue  # stored once in the collection metadata (§V-B)
                for k in range(n_packs):
                    t0, t1 = k * ipack, min((k + 1) * ipack, n_inst)
                    vals = np.stack([
                        tsg.vertex_values(t, a.name)[v_cat] for t in range(t0, t1)
                    ])
                    write_array_slice(
                        os.path.join(pdir, attr_slice_name("v", a.name, b, k)),
                        {"vals": vals},
                    )
            for a in tmpl.edge_attrs:
                if a.constant is not None:
                    continue
                for k in range(n_packs):
                    t0, t1 = k * ipack, min((k + 1) * ipack, n_inst)
                    lvals = np.stack([
                        tsg.edge_values(t, a.name)[le_cat] for t in range(t0, t1)
                    ])
                    rvals = np.stack([
                        tsg.edge_values(t, a.name)[re_cat] for t in range(t0, t1)
                    ])
                    write_array_slice(
                        os.path.join(pdir, attr_slice_name("e", a.name, b, k)),
                        {"local": lvals, "remote": rvals},
                    )
        write_json_slice(os.path.join(pdir, "meta.json"), part_meta)
        global_meta["partitions"][str(p)] = {
            "n_subgraphs": len(gids),
            "n_bins": len(bins),
        }

    if sparse_absent:
        _write_tile_maps(tsg, cfg, root, assign, sparse_absent,
                         n_packs, ipack)
        global_meta["sparse_absent"] = {
            k: float(v) for k, v in sparse_absent.items()
        }
    write_json_slice(os.path.join(root, "collection.json"), global_meta)
    return global_meta


# --------------------------------------------------------------------------
# streaming ingestion: append-only growth of a deployed collection
# --------------------------------------------------------------------------

def _append_attr_slices(
    store, tsg_new: TimeSeriesGraph, root: str,
    old_n: int, new_n: int, ipack: int, n_packs: int,
) -> None:
    """Write the appended instances' attribute values: the tail pack (when
    ``old_n`` is not pack-aligned) is rewritten with its preserved old rows
    plus the new ones (atomically — old readers keep indexing the same
    rows), and each fully-new pack gets a fresh slice per (partition, bin,
    attribute)."""
    meta = store.meta
    k_first = old_n // ipack

    def packs():
        for k in range(k_first, n_packs):
            t0, t1 = k * ipack, min((k + 1) * ipack, new_n)
            yield k, t0, max(t0, old_n), t1

    for p in range(int(meta["num_partitions"])):
        pdir = os.path.join(root, f"part_{p}")
        for b in range(len(store._part_meta[p]["bins"])):
            v_cat = store._bin_concat_ids(p, b, "vertices")
            le_cat = store._bin_concat_ids(p, b, "local_edge_id")
            re_cat = store._bin_concat_ids(p, b, "remote_edge_id")
            for a in meta["vertex_attrs"]:
                if a["constant"] is not None:
                    continue  # stored once in the collection metadata (§V-B)
                name = a["name"]
                for k, t0, s, t1 in packs():
                    vals = np.stack([
                        np.asarray(tsg_new.vertex_values(t - old_n, name))[v_cat]
                        for t in range(s, t1)
                    ])
                    path = os.path.join(pdir, attr_slice_name("v", name, b, k))
                    if s > t0:
                        old = read_array_slice(path)["vals"][: s - t0]
                        vals = np.concatenate(
                            [old, vals.astype(old.dtype, copy=False)])
                    write_array_slice(path, {"vals": vals})
            for a in meta["edge_attrs"]:
                if a["constant"] is not None:
                    continue
                name = a["name"]
                for k, t0, s, t1 in packs():
                    rows = [np.asarray(tsg_new.edge_values(t - old_n, name))
                            for t in range(s, t1)]
                    lvals = np.stack([r[le_cat] for r in rows])
                    rvals = np.stack([r[re_cat] for r in rows])
                    path = os.path.join(pdir, attr_slice_name("e", name, b, k))
                    if s > t0:
                        sl = read_array_slice(path)
                        ol, orr = sl["local"][: s - t0], sl["remote"][: s - t0]
                        lvals = np.concatenate(
                            [ol, lvals.astype(ol.dtype, copy=False)])
                        rvals = np.concatenate(
                            [orr, rvals.astype(orr.dtype, copy=False)])
                    write_array_slice(path, {"local": lvals, "remote": rvals})


def _append_tile_maps(
    store, tsg_new: TimeSeriesGraph, root: str,
    old_n: int, new_n: int, ipack: int, n_packs: int,
) -> None:
    """Extend each recorded tile map + delta chain with the appended
    instances.

    Fast path: when the existing slices validate against the deployment's
    blocked structure and instance count, only the new instances are
    tiled — existing payload ids, per-pack maps and old instances' refs
    are preserved bitwise, and new tiles intern into the recorded pool,
    rehydrated in place (:class:`_TilePool` ``base``).  When either slice
    is missing, stale or corrupt the chain is rebuilt from scratch over
    the full (read-back + appended) history, restoring the
    validate-or-fallback invariant rather than propagating a broken
    chain."""
    meta = store.meta
    sparse_absent = meta.get("sparse_absent") or {}
    if not sparse_absent:
        return
    tmpl = tsg_new.template
    # partition assignment reconstructed from the deployed subgraph homes
    assign = np.zeros(int(meta["num_vertices"]), np.int64)
    for topo in store.iter_subgraphs():
        assign[np.asarray(topo.vertices, np.int64)] = topo.pid
    n_old_packs = -(-old_n // ipack) if old_n else 0

    for name, absent in sparse_absent.items():
        zero = float(absent)
        tm_path = os.path.join(root, tile_map_name(name))
        dl_path = os.path.join(root, delta_slice_name(name))
        tm = dl = None
        try:
            tm = read_array_slice(tm_path)
            dl = read_array_slice(dl_path)
        except (OSError, ValueError, KeyError, EOFError):
            pass
        bsz = None
        for src in (tm, dl):
            if src is not None and "block_size" in src:
                bsz = int(src["block_size"])
                break
        if bsz is None:
            raise ValueError(
                f"append_instances: tile maps for {name!r} are unreadable "
                "and record no block size — cannot extend the chain")
        bg = build_blocked(tmpl, assign, bsz)
        B = int(bg.block_size)

        def matches(src) -> bool:
            return (
                src is not None
                and int(src["block_size"]) == bg.block_size
                and float(src["absent"]) == zero
                and src["tiles_rc"].shape == bg.tiles_rc.shape
                and np.array_equal(src["tiles_rc"], bg.tiles_rc)
                and src["btiles_rc"].shape == bg.btiles_rc.shape
                and np.array_equal(src["btiles_rc"], bg.btiles_rc)
            )

        incremental = (
            matches(tm) and matches(dl)
            and int(dl["n_instances"]) == old_n
            and dl["ref_local"].shape == (old_n, bg.n_parts, bg.t_max)
            and dl["ref_boundary"].shape == (old_n, bg.n_parts, bg.tb_max)
            and int(tm["n_packs"]) == n_old_packs
            and all(f"local_{k}" in tm and f"boundary_{k}" in tm
                    for k in range(n_old_packs))
        )

        def new_row(t: int) -> np.ndarray:
            return np.asarray(tsg_new.edge_values(t - old_n, name), np.float32)

        ref_l = np.full((new_n, bg.n_parts, bg.t_max), -1, np.int32)
        ref_b = np.full((new_n, bg.n_parts, bg.tb_max), -1, np.int32)
        if incremental:
            base_l, base_b = dl["payloads_local"], dl["payloads_boundary"]
            ref_l[:old_n] = dl["ref_local"]
            ref_b[:old_n] = dl["ref_boundary"]
            arrs = dict(tm)
            monotone = bool(int(tm["delta_monotone"]))
            start_t = old_n
            prev_w = (store.edge_attr_rows(name, [old_n - 1])[0]
                      if old_n else None)
            row = new_row
        else:
            # full rebuild: read the old history back through the store
            w_old = store.edge_attr_rows(name, range(old_n))
            base_l = base_b = None
            arrs = {
                "tiles_rc": bg.tiles_rc,
                "btiles_rc": bg.btiles_rc,
                "block_size": np.asarray(bg.block_size, np.int64),
                "absent": np.asarray(absent, np.float64),
            }
            monotone = True
            start_t = 0
            prev_w = None

            def row(t: int) -> np.ndarray:
                return w_old[t] if t < old_n else new_row(t)
        del dl, tm

        # per-pack activity of the rows to tile (the tail pack keeps its
        # recorded old rows), then one instance's fill at a time
        acts: Dict[int, Tuple[int, np.ndarray, np.ndarray]] = {}
        for k in range(start_t // ipack, n_packs):
            t0, t1 = k * ipack, min((k + 1) * ipack, new_n)
            s = max(t0, start_t)
            act_l, act_b = bg.active_tile_maps(
                np.stack([row(t) for t in range(s, t1)]), zero=zero)
            acts[k] = (s, act_l, act_b)
            if s > t0:  # partial tail pack: keep the recorded old rows
                arrs[f"local_{k}"] = np.concatenate(
                    [arrs[f"local_{k}"][: s - t0], act_l.astype(np.uint8)])
                arrs[f"boundary_{k}"] = np.concatenate(
                    [arrs[f"boundary_{k}"][: s - t0], act_b.astype(np.uint8)])
            else:
                arrs[f"local_{k}"] = act_l.astype(np.uint8)
                arrs[f"boundary_{k}"] = act_b.astype(np.uint8)
        pool_l = _TilePool(sum(int(a[1].sum()) for a in acts.values()), B,
                           base=base_l)
        pool_b = _TilePool(sum(int(a[2].sum()) for a in acts.values()), B,
                           base=base_b)
        del base_l, base_b
        for t in range(start_t, new_n):
            s, act_l, act_b = acts[t // ipack]
            wt = row(t)[None]
            _intern_tiles(bg.fill_local_batch(wt, zero=zero)[0],
                          act_l[t - s], pool_l, ref_l[t])
            _intern_tiles(bg.fill_boundary_batch(wt, zero=zero)[0],
                          act_b[t - s], pool_b, ref_b[t])
            if prev_w is not None:
                monotone = monotone and bool(np.all(wt[0] <= prev_w))
            prev_w = wt[0]

        arrs["n_packs"] = np.asarray(n_packs, np.int64)
        n_valid = int(bg.n_tiles.sum()) + int(bg.n_btiles.sum())
        n_active = sum(
            int(arrs[f"local_{k}"].sum()) + int(arrs[f"boundary_{k}"].sum())
            for k in range(n_packs))
        arrs["occupancy"] = np.asarray(
            n_active / max(1, new_n * n_valid), np.float64)
        arrs["delta_unique_ratio"] = np.asarray(
            (len(pool_l) + len(pool_b)) / max(1, n_active), np.float64)
        arrs["delta_monotone"] = np.asarray(int(monotone), np.int64)
        # delta first, tile map second, manifest (caller) last: each write
        # is individually atomic and every intermediate combination an old
        # reader can observe validates (refs/maps only grow, prefix rows
        # are preserved bitwise)
        write_array_slice(dl_path, {
            "tiles_rc": bg.tiles_rc,
            "btiles_rc": bg.btiles_rc,
            "block_size": np.asarray(bg.block_size, np.int64),
            "absent": np.asarray(absent, np.float64),
            "n_instances": np.asarray(new_n, np.int64),
            "payloads_local": pool_l.parts(),
            "payloads_boundary": pool_b.parts(),
            "ref_local": ref_l,
            "ref_boundary": ref_b,
        })
        write_array_slice(tm_path, arrs)


def append_instances(tsg_new: TimeSeriesGraph, root: str) -> Dict:
    """Grow the collection deployed at ``root`` by ``tsg_new``'s instances
    — streaming ingestion, no re-deploy.

    ``tsg_new`` holds ONLY the new instances and must share the deployed
    template (same vertex/edge count and attribute schema).  Partitioning,
    bin packing, the temporal pack size, and sparse/delta recording are
    all inherited from the existing deployment.

    Atomicity: data slices are written first, each with an atomic
    replace; the ``collection.json`` manifest — carrying the bumped
    ``version`` and the extended instance count/timestamps — is replaced
    LAST.  A concurrent reader therefore always observes a complete
    collection: the old version until the manifest lands, the new one
    after.  Old-version readers stay valid across the commit because
    appended writes only add rows/packs — every previously-readable row
    is preserved bitwise.

    Returns the new global metadata dict."""
    from repro_torch.gofs.store import GoFSStore

    meta_path = os.path.join(root, "collection.json")
    n_new = len(tsg_new)
    if n_new == 0:
        return read_json_slice(meta_path)
    store = GoFSStore(root, cache_slots=0)
    meta = dict(store.meta)
    tmpl = tsg_new.template
    if (int(tmpl.num_vertices) != int(meta["num_vertices"])
            or int(tmpl.num_edges) != int(meta["num_edges"])):
        raise ValueError(
            "append_instances: template does not match the deployed "
            f"collection ({tmpl.num_vertices}v/{tmpl.num_edges}e vs "
            f"{meta['num_vertices']}v/{meta['num_edges']}e)")
    old_n = int(meta["num_instances"])
    ipack = int(meta["instances_per_slice"])
    new_n = old_n + n_new
    n_packs = -(-new_n // ipack)

    _append_attr_slices(store, tsg_new, root, old_n, new_n, ipack, n_packs)
    _append_tile_maps(store, tsg_new, root, old_n, new_n, ipack, n_packs)

    meta["num_instances"] = new_n
    meta["timestamps"] = list(meta["timestamps"]) + [
        float(g.timestamp) for g in tsg_new.instances]
    meta["durations"] = list(meta["durations"]) + [
        float(g.duration) for g in tsg_new.instances]
    meta["version"] = int(meta.get("version", 0)) + 1
    write_json_slice(meta_path, meta)
    return meta
