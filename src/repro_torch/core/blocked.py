"""Block-sparse partitioned graph: the device-facing layout.

The paper's template/instance split is what makes this layout efficient:
*topology* (which 128x128 adjacency tiles are non-empty, which tile slot each
edge occupies, the boundary-vertex index space) is computed ONCE from the
template; each *instance* only re-fills tile values from its edge-attribute
array with a precomputed O(E) scatter.

Per-partition data (all partitions padded to identical shapes so they stack
into SPMD arrays with a leading partition axis):

* local adjacency   — tiles over (local vertex) x (local vertex), transposed
  orientation: tile[t, i, j] = weight of edge (row_block*B + i -> col_block*B
  + j), reduced over i during SpMV, i.e. y[dst] = add_u mul(x[src], w).
* incoming boundary — tiles over (global boundary slot) x (local vertex) for
  cut edges arriving at this partition.
* out_slot          — local index -> global boundary slot scatter map for
  vertices this partition must publish (it owns them and some other
  partition reads them).

The boundary exchange is a single semiring combine of a dense
(num_boundary,) buffer per superstep — O(cut vertices), the blocked analogue
of Gopher's O(cut edges) message win over vertex-centric O(edges).

Two instance-value layouts share this template structure:

* **dense** — every template tile slot is materialized per instance:
  ``(I, P, T, B, B)`` tensors (``fill_local_batch``).  Cost is
  ``O(P·T·B²)`` per instance regardless of how many tiles the instance
  actually touches.
* **sparse** (:class:`SparseBlocked`) — only the tiles *active in that
  instance* (holding at least one edge whose weight differs from the
  semiring zero) are packed, together with a per-(instance, partition)
  ``(row, col)`` tile index.  The packed tile axis is padded to a
  power-of-two bucket (:func:`pow2_bucket`) so the number of distinct
  staged shapes stays O(log T).  Cost is ``O(nnz_tiles·B²)`` — the GoFS
  compact-slice claim carried all the way to the device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import GraphTemplate
from repro_torch.kernels.walk_plan import (
    WalkPlan, default_chunk, stack_plans, walk_plan)

INF = float(np.inf)  # min-plus semiring zero (numpy-side copy)


def _out_or_full(out: Optional[np.ndarray], shape: Tuple[int, ...],
                 zero: float) -> np.ndarray:
    """A flat float32 fill target of ``shape`` set to ``zero``: ``out``
    (checked and reset in place) or a new array."""
    if out is None:
        return np.full(int(np.prod(shape)), zero, np.float32)
    assert out.shape == tuple(shape), (out.shape, shape)
    assert out.dtype == np.float32 and out.flags.c_contiguous
    flat = out.reshape(-1)
    flat[...] = zero
    return flat


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(1, n) — the padded tile-count bucket.

    Bucketing bounds the set of distinct staged shapes to O(log T) while
    wasting at most 2x padding tiles.

    >>> [pow2_bucket(n) for n in (0, 1, 2, 3, 8, 9)]
    [1, 1, 2, 4, 8, 16]
    """
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass
class SparseBlocked:
    """Block-sparse instance batch: packed active tiles + per-instance index.

    The template's tile axis (length T) is replaced by a packed axis of
    length ``bucket`` (a power of two >= the largest per-(instance,
    partition) active-tile count).  ``rows``/``cols`` carry the tile index
    — (row_block, col_block) per packed slot, ``-1`` padding — in template
    order, which is col-major sorted per partition, so the packed list
    keeps the contiguous-output-runs invariant the kernels need.
    Skipped tiles hold only semiring zeros, so staging them sparse is
    result-identical (bitwise for min-plus) to the dense layout.
    """

    block_size: int
    tiles: np.ndarray  # (I, P, K, B, B) float32 packed local tile values
    btiles: np.ndarray  # (I, P, Kb, B, B) float32 packed boundary tiles
    rows: np.ndarray  # (I, P, K) int32 row block per packed slot, -1 = pad
    cols: np.ndarray  # (I, P, K) int32 col block per packed slot, -1 = pad
    brows: np.ndarray  # (I, P, Kb) int32 boundary block index, -1 = pad
    bcols: np.ndarray  # (I, P, Kb) int32 local dst block index, -1 = pad
    nnz: np.ndarray  # (I, P) int32 active local tiles
    bnnz: np.ndarray  # (I, P) int32 active boundary tiles
    total_tiles: int  # template valid local tiles, summed over partitions
    total_btiles: int  # template valid boundary tiles
    # bytes actually materialized from the backing store, when that is less
    # than ``staged_bytes()`` (a delta-encoded store read decodes each unique
    # tile payload once).  None = fully materialized (source == staged).
    source_bytes: Optional[int] = None

    @property
    def num_instances(self) -> int:
        return self.tiles.shape[0]

    @property
    def bucket(self) -> int:
        return self.tiles.shape[2]

    @property
    def bbucket(self) -> int:
        return self.btiles.shape[2]

    def occupancy(self) -> float:
        """Fraction of template tiles active, averaged over instances."""
        total = self.num_instances * (self.total_tiles + self.total_btiles)
        if total == 0:
            return 0.0
        return float(self.nnz.sum() + self.bnnz.sum()) / total

    def staged_bytes(self) -> int:
        """Host bytes materialized for this batch (values + tile index)."""
        return int(
            self.tiles.nbytes + self.btiles.nbytes + self.rows.nbytes
            + self.cols.nbytes + self.brows.nbytes + self.bcols.nbytes
        )


@dataclass
class BlockedGraph:
    """Static blocked structure for all partitions (host-side, numpy)."""

    block_size: int
    n_parts: int
    # --- vertex numbering -------------------------------------------------
    # global vertex id -> (partition, local index); locals are contiguous,
    # grouped bin-major (paper §V-D ordered iterators), padded to B multiple.
    part_of: np.ndarray  # (V,) int32
    local_of: np.ndarray  # (V,) int32
    global_of: np.ndarray  # (P, Vp) int64, -1 = padding
    vp: int  # padded local vertex count (same for all partitions)
    # --- local adjacency tiles ---------------------------------------------
    tiles_rc: np.ndarray  # (P, T, 2) int32 (row_block, col_block), -1 = pad
    n_tiles: np.ndarray  # (P,) int32 valid tile count
    # edge -> (partition, tile, i, j) fill map for local edges
    le_edge_id: np.ndarray  # (Lp_total,) int64 template edge ids
    le_part: np.ndarray  # (Lp_total,) int32
    le_flat: np.ndarray  # (Lp_total,) int64 flat index into (T*B*B) per part
    # --- boundary ----------------------------------------------------------
    num_boundary: int  # padded to B multiple
    # remote (cut) edges: src published at a boundary slot, consumed by dst's
    # partition through boundary tiles.
    bslot_of_src: np.ndarray  # (num_boundary,) int64 global vertex publishing
    out_slot: np.ndarray  # (P, Omax) int32 boundary slot per published vertex
    out_local: np.ndarray  # (P, Omax) int32 local index of published vertex
    n_out: np.ndarray  # (P,) int32
    btiles_rc: np.ndarray  # (P, Tb, 2) int32 (boundary_block, col_block)
    n_btiles: np.ndarray  # (P,) int32
    re_edge_id: np.ndarray  # (Rp_total,) int64 template edge ids (cut edges)
    re_part: np.ndarray  # (Rp_total,) int32 destination partition
    re_flat: np.ndarray  # (Rp_total,) int64 flat index into (Tb*B*B) per part
    # lazily computed: is each fill map duplicate-free (no parallel edges
    # sharing a tile slot)?  If so the batched fill can use vectorized
    # assignment instead of the much slower combining ``ufunc.at``.
    _le_unique: Optional[bool] = None
    _re_unique: Optional[bool] = None

    @property
    def t_max(self) -> int:
        return self.tiles_rc.shape[1]

    @property
    def tb_max(self) -> int:
        return self.btiles_rc.shape[1]

    @property
    def o_max(self) -> int:
        return self.out_slot.shape[1]

    @property
    def boundary_nnz(self) -> int:
        """Boundary vertices actually published per superstep — the real
        cut size the comm cost model should see, as opposed to the padded
        ``num_boundary`` buffer length."""
        return int(self.n_out.sum())

    @classmethod
    def from_arrays(cls, mapping) -> "BlockedGraph":
        """Build from another blocked graph's fields given as a mapping of
        name -> numpy array or int (e.g. ``vars(bg)`` of the JAX package's
        ``BlockedGraph``, which has the same fields).  Arrays are copied,
        so the result shares no memory with the source; private caches
        are recomputed lazily."""
        kw = {}
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            v = mapping[f.name]
            kw[f.name] = int(v) if f.type == "int" else np.array(v)
        return cls(**kw)

    # ------------------------------------------------------------------ fill
    # Parallel edges between the same (src, dst) land in the same tile slot;
    # they must be COMBINED with the semiring add (min for tropical / sum for
    # arithmetic), never overwritten — the zero value selects the op.
    def fill_local(self, weights: np.ndarray, zero: float = INF) -> np.ndarray:
        """Edge weights (E,) -> local tile values (P, T, B, B)."""
        return self.fill_local_batch(np.asarray(weights)[None], zero)[0]

    def fill_boundary(self, weights: np.ndarray, zero: float = INF) -> np.ndarray:
        """Edge weights (E,) -> boundary tile values (P, Tb, B, B)."""
        return self.fill_boundary_batch(np.asarray(weights)[None], zero)[0]

    # ------------------------------------------------------- batched staging
    # One flat scatter for ALL instances at once (the edge -> tile-slot map
    # is instance-invariant, so the instance axis broadcasts).
    def _fill_batch(
        self, weights: np.ndarray, zero: float, part: np.ndarray,
        flat: np.ndarray, edge_id: np.ndarray, t_count: int,
        out: Optional[np.ndarray], slots_unique: bool,
    ) -> np.ndarray:
        B = self.block_size
        I, P = weights.shape[0], self.n_parts
        per_inst = P * t_count * B * B
        vals = _out_or_full(out, (I, P, t_count, B, B), zero)
        slot = part.astype(np.int64) * (t_count * B * B) + flat
        idx = (np.arange(I, dtype=np.int64)[:, None] * per_inst + slot[None, :])
        if slots_unique:
            # no parallel edges share a slot: semiring combining is a
            # no-op, and vectorized assignment is ~6x faster than ufunc.at
            vals[idx.ravel()] = weights[:, edge_id].ravel()
        else:
            op = np.minimum if zero == INF else np.add
            op.at(vals, idx.ravel(), weights[:, edge_id].ravel())
        return vals.reshape(I, P, t_count, B, B)

    def _slot_key(self, part: np.ndarray, flat: np.ndarray, t_count: int):
        return part.astype(np.int64) * (t_count * self.block_size ** 2) + flat

    def _local_slots_unique(self) -> bool:
        """Is the local fill map duplicate-free (lazily probed once)?"""
        if self._le_unique is None:
            key = self._slot_key(self.le_part, self.le_flat, self.t_max)
            self._le_unique = bool(len(np.unique(key)) == len(key))
        return self._le_unique

    def _boundary_slots_unique(self) -> bool:
        if self._re_unique is None:
            key = self._slot_key(self.re_part, self.re_flat, self.tb_max)
            self._re_unique = bool(len(np.unique(key)) == len(key))
        return self._re_unique

    def fill_local_batch(
        self, weights: np.ndarray, zero: float = INF,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Instance edge weights (I, E) -> local tiles (I, P, T, B, B).

        ``out``: optional (I, P, T, B, B) float32 buffer filled in place
        (see ``alloc_batch_buffers``), so the prefetcher fills chunk
        buffers it owns with no second copy."""
        return self._fill_batch(
            np.asarray(weights, np.float32), zero, self.le_part,
            self.le_flat, self.le_edge_id, self.t_max, out,
            self._local_slots_unique(),
        )

    def fill_boundary_batch(
        self, weights: np.ndarray, zero: float = INF,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Instance edge weights (I, E) -> boundary tiles (I, P, Tb, B, B).

        ``out``: as in ``fill_local_batch``."""
        return self._fill_batch(
            np.asarray(weights, np.float32), zero, self.re_part,
            self.re_flat, self.re_edge_id, self.tb_max, out,
            self._boundary_slots_unique(),
        )

    def alloc_batch_buffers(
        self, max_instances: int, *,
        bucket: Optional[int] = None, bbucket: Optional[int] = None,
        empty: Callable[[Tuple[int, ...]], np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Allocate one (local, boundary) fill-buffer pair sized for
        ``max_instances`` — the unit the prefetcher fills.

        ``bucket``/``bbucket`` size the tile axes for the sparse layout's
        padded power-of-two buckets instead of the dense ``t_max``/
        ``tb_max``.  ``empty(shape)`` makes each float32 buffer
        (``np.empty`` by default); on CUDA the engine passes one that
        hands out views of pinned host memory."""
        B = self.block_size
        make = empty or (lambda shape: np.empty(shape, np.float32))
        return (make((max_instances, self.n_parts, bucket or self.t_max,
                      B, B)),
                make((max_instances, self.n_parts, bbucket or self.tb_max,
                      B, B)))

    # ------------------------------------------------------- sparse staging
    # A tile is ACTIVE for an instance iff at least one edge mapping into it
    # carries a weight != the semiring zero.  Inactive tiles contribute
    # exact semiring zeros to the SpMV (min with +inf / sum with 0.0), so
    # packing only active tiles is result-identical to the dense layout —
    # bitwise for min-plus, where min is order-exact.
    def _active_tiles(
        self, w: np.ndarray, zero: float, part: np.ndarray,
        flat: np.ndarray, edge_id: np.ndarray, t_count: int,
    ) -> np.ndarray:
        """(I, E) weights -> (I, P, t_count) bool active-tile mask."""
        B2 = self.block_size * self.block_size
        I, P = w.shape[0], self.n_parts
        act = np.zeros((I, P * t_count), bool)
        if len(edge_id):
            tile_key = part.astype(np.int64) * t_count + flat // B2  # (L,)
            live = w[:, edge_id] != zero  # (I, L)
            ii, ll = np.nonzero(live)
            act[ii, tile_key[ll]] = True
        return act.reshape(I, P, t_count)

    def pack_tile_index(
        self, act: np.ndarray, rc: np.ndarray, *,
        bucket: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Active-tile mask (I, P, T) -> packed index (rows, cols, nnz, slot).

        ``slot[i, p, t]`` is the packed position of template tile ``t``
        (valid where ``act``), assigned in template order so the packed
        subset keeps the col-major contiguous-output-runs invariant the
        kernels need."""
        I, P, t_count = act.shape
        nnz = act.sum(-1, dtype=np.int32)  # (I, P)
        max_nnz = int(nnz.max()) if nnz.size else 0
        K = int(bucket) if bucket is not None else pow2_bucket(max_nnz)
        assert K >= max_nnz, \
            f"bucket {K} < max active tiles {max_nnz} (stale tile map?)"
        slot = np.cumsum(act, axis=-1, dtype=np.int64) - 1  # valid where act
        rows = np.full((I, P, K), -1, np.int32)
        cols = np.full((I, P, K), -1, np.int32)
        ii, pp, tt = np.nonzero(act)
        ss = slot[ii, pp, tt]
        rows[ii, pp, ss] = rc[pp, tt, 0]
        cols[ii, pp, ss] = rc[pp, tt, 1]
        return rows, cols, nnz, slot

    def pack_payload_tiles(
        self, ref: np.ndarray, payloads: np.ndarray, rc: np.ndarray,
        zero: float, *, bucket: Optional[int] = None,
        out: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Reconstruct a packed batch from a delta-encoded tile chain.

        ``ref`` (I, P, T) indexes each active template-tile slot into the
        deduplicated ``payloads`` (U, B, B) pool (-1 = inactive); the
        gather is a RAM copy, so a payload shared by many instances is
        decoded from the store only once.  Returns (vals, rows, cols, nnz)
        exactly as ``fill_local_batch_sparse`` would for the full weights:
        ``pack_tile_index`` assigns the slots of both.  ``out``: a
        buffer filled in place, as in ``fill_local_batch``."""
        B = self.block_size
        act = ref >= 0
        rows, cols, nnz, slot = self.pack_tile_index(act, rc, bucket=bucket)
        I, P, K = rows.shape
        vals = _out_or_full(out, (I, P, K, B, B), zero).reshape(
            I, P, K, B, B)
        for i in range(I):  # one instance's gather at a time: no temporary
            pp, tt = np.nonzero(act[i])  # the size of the whole batch
            vals[i, pp, slot[i, pp, tt]] = payloads[ref[i, pp, tt]]
        return vals, rows, cols, nnz

    def _fill_batch_sparse(
        self, w: np.ndarray, zero: float, part: np.ndarray,
        flat: np.ndarray, edge_id: np.ndarray, t_count: int,
        rc: np.ndarray, bucket: Optional[int], out: Optional[np.ndarray],
        slots_unique: bool, act: Optional[np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Packed-tile fill.  Returns (vals (I, P, K, B, B), rows (I, P, K),
        cols (I, P, K), nnz (I, P))."""
        B = self.block_size
        B2 = B * B
        I, P = w.shape[0], self.n_parts
        if act is None:
            act = self._active_tiles(w, zero, part, flat, edge_id, t_count)
        assert act.shape == (I, P, t_count), act.shape
        rows, cols, nnz, slot = self.pack_tile_index(act, rc, bucket=bucket)
        K = rows.shape[2]
        vals = _out_or_full(out, (I, P, K, B, B), zero)
        if len(edge_id):
            tile_key = part.astype(np.int64) * t_count + flat // B2  # (L,)
            within = flat % B2
            keep = act.reshape(I, P * t_count)[:, tile_key]  # (I, L) bool
            # gather destinations/values only at the KEPT (instance, edge)
            # pairs — no full (I, L) weight/offset temporaries beyond the
            # boolean mask itself
            ki, kl = np.nonzero(keep)
            pslot = slot.reshape(I, P * t_count)[ki, tile_key[kl]]
            didx = ((ki * np.int64(P) + part[kl]) * K + pslot) * B2 \
                + within[kl]
            dvals = w[ki, edge_id[kl]]
            if slots_unique:
                vals[didx] = dvals
            else:
                op = np.minimum if zero == INF else np.add
                op.at(vals, didx, dvals)
        return vals.reshape(I, P, K, B, B), rows, cols, nnz

    def fill_local_batch_sparse(
        self, weights: np.ndarray, zero: float = INF, *,
        bucket: Optional[int] = None, out: Optional[np.ndarray] = None,
        act: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Instance edge weights (I, E) -> packed local tiles.

        Returns (vals (I, P, K, B, B), rows (I, P, K), cols (I, P, K),
        nnz (I, P)) with K = ``bucket`` or the pow2 bucket of the batch's
        max active-tile count.  ``act``: precomputed (I, P, T) active-tile
        mask; ``out``: a buffer filled in place, as in
        ``fill_local_batch``."""
        return self._fill_batch_sparse(
            np.asarray(weights, np.float32), zero, self.le_part,
            self.le_flat, self.le_edge_id, self.t_max, self.tiles_rc,
            bucket, out, self._local_slots_unique(), act,
        )

    def fill_boundary_batch_sparse(
        self, weights: np.ndarray, zero: float = INF, *,
        bucket: Optional[int] = None, out: Optional[np.ndarray] = None,
        act: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Instance edge weights (I, E) -> packed boundary tiles (see
        ``fill_local_batch_sparse``)."""
        return self._fill_batch_sparse(
            np.asarray(weights, np.float32), zero, self.re_part,
            self.re_flat, self.re_edge_id, self.tb_max, self.btiles_rc,
            bucket, out, self._boundary_slots_unique(), act,
        )

    def active_tile_maps(
        self, weights: np.ndarray, zero: float = INF
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(I, E) weights -> ((I, P, T), (I, P, Tb)) bool active-tile maps
        — the per-pack record GoFS deployment persists next to the
        attribute slices (``repro_torch.gofs.layout``)."""
        w = np.asarray(weights, np.float32)
        if w.ndim == 1:
            w = w[None]
        return (
            self._active_tiles(w, zero, self.le_part, self.le_flat,
                               self.le_edge_id, self.t_max),
            self._active_tiles(w, zero, self.re_part, self.re_flat,
                               self.re_edge_id, self.tb_max),
        )

    def sparse_buckets(
        self, weights: np.ndarray, zero: float = INF
    ) -> Tuple[int, int]:
        """Pow2 (local, boundary) tile buckets for a weight batch — the
        shape every chunk of the batch should share."""
        la, ba = self.active_tile_maps(weights, zero)
        lmax = int(la.sum(-1).max()) if la.size else 0
        bmax = int(ba.sum(-1).max()) if ba.size else 0
        return pow2_bucket(lmax), pow2_bucket(bmax)

    def stage_sparse(
        self, weights: np.ndarray, zero: float = INF, *,
        bucket: Optional[int] = None, bbucket: Optional[int] = None,
        act_local: Optional[np.ndarray] = None,
        act_boundary: Optional[np.ndarray] = None,
    ) -> SparseBlocked:
        """(I, E) edge weights -> :class:`SparseBlocked` packed batch."""
        w = np.asarray(weights, np.float32)
        if w.ndim == 1:
            w = w[None]
        tiles, rows, cols, nnz = self.fill_local_batch_sparse(
            w, zero=zero, bucket=bucket, act=act_local,
        )
        btiles, brows, bcols, bnnz = self.fill_boundary_batch_sparse(
            w, zero=zero, bucket=bbucket, act=act_boundary,
        )
        return SparseBlocked(
            block_size=self.block_size,
            tiles=tiles, btiles=btiles,
            rows=rows, cols=cols, brows=brows, bcols=bcols,
            nnz=nnz, bnnz=bnnz,
            total_tiles=int(self.n_tiles.sum()),
            total_btiles=int(self.n_btiles.sum()),
        )

    def packed_plans(self, cols: np.ndarray, nnz: np.ndarray) -> WalkPlan:
        """Walk plans of a packed (I, P, K) column index with valid counts
        (I, P), one per instance, stacked on a leading instance axis."""
        nvb = self.vp // self.block_size
        chunk = default_chunk(self.block_size)
        return stack_plans(walk_plan(c, nvb, nnz=n, chunk=chunk)
                           for c, n in zip(cols, nnz))

    # ------------------------------------------------------------- vertex io
    def scatter_vertex(self, values: np.ndarray, pad: float) -> np.ndarray:
        """Global (V,) vertex values -> padded per-partition (P, Vp)."""
        out = np.full((self.n_parts, self.vp), pad, np.float32)
        out[self.part_of, self.local_of] = values
        return out

    def gather_vertex(self, padded: np.ndarray) -> np.ndarray:
        """Padded per-partition (P, Vp) -> global (V,) vertex values."""
        return np.asarray(padded)[self.part_of, self.local_of]


def build_blocked(
    template: GraphTemplate,
    assign: np.ndarray,
    block_size: int = 128,
    *,
    vertex_order: Optional[np.ndarray] = None,
) -> BlockedGraph:
    """Compute the static blocked structure from template + partitioning.

    ``vertex_order``: optional (V,) permutation controlling local numbering
    within each partition (e.g. bin-major subgraph order; default = ascending
    global id).
    """
    B = block_size
    V = template.num_vertices
    P = int(assign.max()) + 1 if len(assign) else 1
    src, dst = template.src, template.dst

    # --- local numbering, grouped by partition in the given order ----------
    order = vertex_order if vertex_order is not None else np.arange(V)
    part_of = assign.astype(np.int32)
    local_of = np.zeros(V, np.int32)
    counts = np.zeros(P, np.int64)
    globals_per_part: List[List[int]] = [[] for _ in range(P)]
    for v in order:
        p = part_of[v]
        local_of[v] = counts[p]
        counts[p] += 1
        globals_per_part[p].append(int(v))
    vp = int(-(-max(1, counts.max()) // B) * B)
    global_of = np.full((P, vp), -1, np.int64)
    for p in range(P):
        g = globals_per_part[p]
        global_of[p, : len(g)] = g

    # --- local edges -> tiles ----------------------------------------------
    local_mask = part_of[src] == part_of[dst]
    le = np.nonzero(local_mask)[0]
    le_p = part_of[src[le]]
    li, lj = local_of[src[le]], local_of[dst[le]]  # row = src, col = dst
    rb, cb = li // B, lj // B
    ri, cj = li % B, lj % B
    # unique tiles ordered (part, col_block, row_block): col-major order is
    # gives every output block one contiguous run of tiles, which the
    # kernels' run walk needs.
    nvb = vp // B
    tile_key = (le_p.astype(np.int64) * nvb + cb) * nvb + rb
    uniq, tile_idx = np.unique(tile_key, return_inverse=True)
    t_part = uniq // (nvb * nvb)
    t_cb = (uniq // nvb) % nvb
    t_rb = uniq % nvb
    n_tiles = np.bincount(t_part.astype(np.int64), minlength=P).astype(np.int32)
    t_max = int(max(1, n_tiles.max()))
    tiles_rc = np.full((P, t_max, 2), -1, np.int32)
    # index of each unique tile within its partition
    tile_local = np.zeros(len(uniq), np.int64)
    c = np.zeros(P, np.int64)
    for i in range(len(uniq)):
        p = int(t_part[i])
        tile_local[i] = c[p]
        tiles_rc[p, c[p]] = (t_rb[i], t_cb[i])
        c[p] += 1
    le_flat = tile_local[tile_idx] * B * B + ri.astype(np.int64) * B + cj
    le_edge_id = le.astype(np.int64)
    le_part = le_p.astype(np.int32)

    # --- boundary slots ------------------------------------------------------
    cut = np.nonzero(~local_mask)[0]
    # publishers: unique cut-edge sources (each owned by exactly one part)
    pub = np.unique(src[cut]) if len(cut) else np.array([], np.int64)
    nb = int(-(-max(1, len(pub)) // B) * B)
    bslot = np.full(nb, -1, np.int64)
    bslot[: len(pub)] = pub
    slot_of_vertex = {int(v): s for s, v in enumerate(pub)}

    # per-partition publish maps
    n_out = np.zeros(P, np.int32)
    outs: List[List[Tuple[int, int]]] = [[] for _ in range(P)]
    for s, v in enumerate(pub):
        p = int(part_of[v])
        outs[p].append((s, int(local_of[v])))
    for p in range(P):
        n_out[p] = len(outs[p])
    o_max = int(max(1, n_out.max()))
    out_slot = np.zeros((P, o_max), np.int32)
    out_local = np.zeros((P, o_max), np.int32)
    for p in range(P):
        for i, (s, l) in enumerate(outs[p]):
            out_slot[p, i] = s
            out_local[p, i] = l

    # --- boundary tiles: (boundary block) x (local dst block) ---------------
    if len(cut):
        re_p = part_of[dst[cut]]
        bi = np.array([slot_of_vertex[int(v)] for v in src[cut]], np.int64)
        bj = local_of[dst[cut]].astype(np.int64)
        brb, bcb = bi // B, bj // B
        bri, bcj = bi % B, bj % B
        nbb = nb // B
        bkey = (re_p.astype(np.int64) * nvb + bcb) * nbb + brb
        buniq, btile_idx = np.unique(bkey, return_inverse=True)
        bt_part = buniq // (nbb * nvb)
        bt_cb = (buniq // nbb) % nvb
        bt_rb = buniq % nbb
        n_btiles = np.bincount(bt_part.astype(np.int64), minlength=P).astype(np.int32)
        tb_max = int(max(1, n_btiles.max()))
        btiles_rc = np.full((P, tb_max, 2), -1, np.int32)
        btile_local = np.zeros(len(buniq), np.int64)
        c = np.zeros(P, np.int64)
        for i in range(len(buniq)):
            p = int(bt_part[i])
            btile_local[i] = c[p]
            btiles_rc[p, c[p]] = (bt_rb[i], bt_cb[i])
            c[p] += 1
        re_flat = btile_local[btile_idx] * B * B + bri * B + bcj
        re_edge_id = cut.astype(np.int64)
        re_part = re_p.astype(np.int32)
    else:
        n_btiles = np.zeros(P, np.int32)
        tb_max = 1
        btiles_rc = np.full((P, 1, 2), -1, np.int32)
        re_flat = np.array([], np.int64)
        re_edge_id = np.array([], np.int64)
        re_part = np.array([], np.int32)

    return BlockedGraph(
        block_size=B,
        n_parts=P,
        part_of=part_of,
        local_of=local_of,
        global_of=global_of,
        vp=vp,
        tiles_rc=tiles_rc,
        n_tiles=n_tiles,
        le_edge_id=le_edge_id,
        le_part=le_part,
        le_flat=le_flat,
        num_boundary=nb,
        bslot_of_src=bslot,
        out_slot=out_slot,
        out_local=out_local,
        n_out=n_out,
        btiles_rc=btiles_rc,
        n_btiles=n_btiles,
        re_edge_id=re_edge_id,
        re_part=re_part,
        re_flat=re_flat,
    )
