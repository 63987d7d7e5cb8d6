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

Appending instances to a deployed collection (``append_instances``,
``deploy_collection(append=True)``) is not ported yet (ROADMAP queue 1,
item 5).
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.core.blocked import build_blocked
from repro_torch.core.engine import _not_ported
from repro_torch.core.graph import TimeSeriesGraph
from repro_torch.core.partition import (
    bin_pack_subgraphs,
    discover_subgraphs,
    partition_graph,
)
from repro_torch.core.subgraph import build_subgraphs
from repro_torch.gofs.slices import write_array_slice, write_json_slice


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
    ``capacity`` bounds the unique count (the active tiles to intern);
    pages of the buffer past the unique count are never touched."""

    def __init__(self, capacity: int, block_size: int):
        B = block_size
        self._buf = np.empty((max(1, capacity), B, B), np.float32)
        self._n = 0
        self._ids: Dict[bytes, List[int]] = {}

    def intern(self, tile: np.ndarray) -> int:
        tile = np.ascontiguousarray(tile, np.float32)
        key = hashlib.blake2b(tile, digest_size=16).digest()
        bits = tile.view(np.uint32)
        ids = self._ids.setdefault(key, [])
        for pid in ids:
            if np.array_equal(self._buf[pid].view(np.uint32), bits):
                return pid
        pid = self._n
        self._buf[pid] = tile
        self._n += 1
        ids.append(pid)
        return pid

    def __len__(self) -> int:
        return self._n

    def payloads(self) -> np.ndarray:
        """(U, B, B) unique tiles, in id order."""
        return self._buf[: self._n]


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
                "payloads_local": pool_l.payloads(),
                "payloads_boundary": pool_b.payloads(),
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

    ``append=True`` (grow a deployed collection in place) is not ported
    yet and raises ``NotImplementedError``.

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


def append_instances(tsg_new: TimeSeriesGraph, root: str) -> Dict:
    """Grow the collection deployed at ``root`` by ``tsg_new``'s instances
    in place.  Not ported yet (streaming ingestion)."""
    raise _not_ported("append_instances (streaming ingestion into a "
                      "deployed collection)", "5")
