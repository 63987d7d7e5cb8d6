"""Signed zeros in the port's min-plus folds, against the JAX package.

The reference folds min-plus with ``jnp.minimum``, ``jnp.min`` and
``jax.ops.segment_min``, which order -0 below +0 whatever the order of
the operands.  ``torch.minimum``, ``torch.amin`` and ``scatter_reduce``
keep whichever equal operand comes first, so the port's folds repair the
sign.  Each control holds the port bitwise against the reference in both
orders of its operands, or of its tiles: the semiring's ``add``,
``add_reduce``, ``segment_reduce`` and ``scatter_add``, the plain SpMV and
fused-step kernels (against the Pallas kernels in interpret mode and the
jnp oracles), the walk plan's fold, and min-plus engine runs with a -0
state.  NaN and infinities go through the same folds: NaN entries must
sit where the reference's do (their payloads are not compared), every
other entry is compared bit for bit.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as J
from repro.configs.goffish_tr import TR_TINY as J_TR_TINY
from repro.core.blocked import build_blocked as j_build_blocked
from repro.core.generator import generate_collection as j_generate
from repro.core.partition import partition_graph as j_partition
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS
from repro.kernels.semiring_spmm.ops import spmv_blocked as j_spmv
from repro.kernels.semiring_superstep.ops import fused_step as j_fused
import repro_torch.core.engine as T
from repro_torch.configs.goffish_tr import TR_TINY
from repro_torch.core.blocked import build_blocked
from repro_torch.core.generator import generate_collection
from repro_torch.core.partition import partition_graph
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
from repro_torch.kernels.semiring_superstep.ref import fused_step_ref
from repro_torch.kernels.walk_plan import fold_by_plan, walk_plan

NAN, INF = float("nan"), float("inf")
# every value a min-plus state or weight may hold at a tie or a NaN
SPECIAL = (0.0, -0.0, INF, -INF, NAN, 1.5, -1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(got, want):
    """NaN where the reference has NaN; every other entry bit for bit
    (so -0 is not +0)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _pairs():
    """Every ordered pair of SPECIAL values, as two (n,) arrays."""
    a, b = zip(*itertools.product(SPECIAL, SPECIAL))
    return np.array(a, np.float32), np.array(b, np.float32)


def test_add_orders_negative_zero_first():
    a, b = _pairs()
    got = MIN_PLUS.add(torch.from_numpy(a), torch.from_numpy(b))
    _same_bits(got, J_MIN_PLUS.add(jnp.asarray(a), jnp.asarray(b)))
    # a broadcast operand, both ways round
    for s in (0.0, -0.0):
        one = torch.tensor(s)
        _same_bits(MIN_PLUS.add(one, torch.from_numpy(b)),
                   J_MIN_PLUS.add(jnp.float32(s), jnp.asarray(b)))
        _same_bits(MIN_PLUS.add(torch.from_numpy(a), one),
                   J_MIN_PLUS.add(jnp.asarray(a), jnp.float32(s)))


@pytest.mark.parametrize("axis", [0, 1])
def test_add_reduce_orders_negative_zero_first(axis):
    """Rows of three values drawn from SPECIAL, every order of each
    triple, reduced along either axis."""
    rows = np.array(list(itertools.permutations(
        (0.0, -0.0, 0.0))) + list(itertools.product(SPECIAL, repeat=3)),
        np.float32)
    x = rows if axis == 1 else rows.T.copy()
    _same_bits(MIN_PLUS.add_reduce(torch.from_numpy(x), axis),
               J_MIN_PLUS.add_reduce(jnp.asarray(x), axis))


@pytest.mark.parametrize("order", ["forward", "reversed"])
def test_segment_reduce_orders_negative_zero_first(order):
    """Two-entry segments over every ordered pair, plus empty segments;
    rows of width 3 so that the sign is repaired column by column."""
    a, b = _pairs()
    vals = np.stack([a, b], 1).reshape(-1)  # pair k is entries 2k, 2k+1
    seg = np.repeat(np.arange(len(a)), 2)
    if order == "reversed":
        vals, seg = vals[::-1].copy(), seg[::-1].copy()
    wide = np.stack([vals, vals[::-1], np.roll(vals, 1)], 1)
    n = len(a) + 2
    got = MIN_PLUS.segment_reduce(torch.from_numpy(wide),
                                  torch.from_numpy(seg), n)
    want = J_MIN_PLUS.segment_reduce(jnp.asarray(wide), jnp.asarray(seg), n)
    _same_bits(got, want)


def test_scatter_add_orders_negative_zero_first():
    """An accumulating scatter into slots that hold +0, -0 and +inf, with
    duplicate indices in both orders."""
    rng = np.random.default_rng(3)
    y = np.array([0.0, -0.0, INF, 0.0, -0.0, INF], np.float32)
    idx = np.repeat(np.arange(6), 4)
    vals = rng.choice(np.array([0.0, -0.0, INF], np.float32), len(idx))
    for i, v in ((idx, vals), (idx[::-1].copy(), vals[::-1].copy())):
        got = MIN_PLUS.scatter_add(torch.from_numpy(y)[None],
                                   torch.from_numpy(i)[None],
                                   torch.from_numpy(v)[None])[0]
        want = J_MIN_PLUS.scatter_add(jnp.asarray(y), jnp.asarray(i),
                                      jnp.asarray(v))
        _same_bits(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_nan_and_infinities_fold_as_the_reference(axis):
    """No zero at all: NaN propagates and ±inf order as the reference's
    folds do, in every order (the folds before the signed-zero repair
    did this too)."""
    vals = (INF, -INF, NAN, 2.5, -2.5)
    rows = np.array(list(itertools.product(vals, repeat=3)), np.float32)
    x = rows if axis == 1 else rows.T.copy()
    _same_bits(MIN_PLUS.add_reduce(torch.from_numpy(x), axis),
               J_MIN_PLUS.add_reduce(jnp.asarray(x), axis))
    a, b = rows[:, 0].copy(), rows[:, 1].copy()
    _same_bits(MIN_PLUS.add(torch.from_numpy(a), torch.from_numpy(b)),
               J_MIN_PLUS.add(jnp.asarray(a), jnp.asarray(b)))
    seg = np.repeat(np.arange(len(rows)), 3)
    _same_bits(MIN_PLUS.segment_reduce(torch.from_numpy(rows.reshape(-1)),
                                       torch.from_numpy(seg), len(rows)),
               J_MIN_PLUS.segment_reduce(jnp.asarray(rows.reshape(-1)),
                                         jnp.asarray(seg), len(rows)))


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
def test_spmv_ref_nan_and_infinities(reverse):
    """Weights and states of 1, 2, +inf, -inf and NaN (no zero), both tile
    orders: the plain SpMV equals the reference's."""
    rng = np.random.default_rng(9)
    B, nvb, T_ = 8, 3, 9
    cols = np.sort(rng.integers(0, nvb, T_)).astype(np.int32)
    rows = rng.integers(0, nvb, T_).astype(np.int32)
    v = np.array([1.0, 2.0, INF, INF, -INF, NAN], np.float32)
    tiles = rng.choice(v[:5], (T_, B, B))
    tiles[2, 1, 1] = NAN
    x = rng.choice(v[:4], nvb * B)
    if reverse:
        order = np.lexsort((-np.arange(T_), cols))
        tiles, rows, cols = tiles[order], rows[order], cols[order]
    got, pallas, oracle = _spmv_both(tiles, rows, cols, x, nvb)
    _same_bits(got, oracle)
    _same_bits(got, pallas)


# ---------------------------------------------------------------------------
# the plain kernels
# ---------------------------------------------------------------------------

def _two_tile_control(B=8, reverse=False):
    """One output block, two tiles: x = -0 at both tiles' rows, weights
    +0 in one tile and -0 in the other, so one tile offers +0 and the
    other -0 at every output; ``reverse`` swaps the tiles' order."""
    tiles = np.stack([np.full((B, B), 0.0, np.float32),
                      np.full((B, B), -0.0, np.float32)])
    rows = np.array([0, 1], np.int32)
    cols = np.zeros(2, np.int32)
    if reverse:
        tiles, rows = tiles[::-1].copy(), rows[::-1].copy()
    x = np.full(2 * B, -0.0, np.float32)
    return tiles, rows, cols, x


def _zero_control(seed, B=8, nvb=3, T_=9, reverse=False):
    """Random tiles and states of +0, -0 and +inf (plus a NaN and a -inf),
    columns sorted; ``reverse`` reverses the order of the tiles inside
    each column's run."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, nvb, T_)).astype(np.int32)
    rows = rng.integers(0, nvb, T_).astype(np.int32)
    z = np.array([0.0, -0.0, 0.0, -0.0, INF], np.float32)
    tiles = rng.choice(z, (T_, B, B))
    x = rng.choice(z, nvb * B)
    tiles[0, 0, 1], x[2], tiles[-1, 3, 3] = NAN, NAN, -INF
    if reverse:
        order = np.lexsort((-np.arange(T_), cols))
        tiles, rows, cols = tiles[order], rows[order], cols[order]
    return tiles, rows, cols, x


def _spmv_both(tiles, rows, cols, x, nob):
    got = spmv_blocked_ref(torch.from_numpy(tiles), torch.from_numpy(rows),
                           torch.from_numpy(cols), torch.from_numpy(x),
                           MIN_PLUS, n_out_blocks=nob)
    jargs = (jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
             jnp.asarray(x), J_MIN_PLUS)
    pallas = j_spmv(*jargs, n_out_blocks=nob, use_pallas=True,
                    interpret=True)
    oracle = j_spmv(*jargs, n_out_blocks=nob, use_pallas=False)
    return got, pallas, oracle


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
def test_spmv_ref_two_tile_control(reverse):
    tiles, rows, cols, x = _two_tile_control(reverse=reverse)
    got, pallas, oracle = _spmv_both(tiles, rows, cols, x, 1)
    assert np.all(np.signbit(np.asarray(oracle)))  # the control bites
    _same_bits(got, oracle)
    _same_bits(got, pallas)


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spmv_ref_zero_control(seed, reverse):
    tiles, rows, cols, x = _zero_control(seed, reverse=reverse)
    got, pallas, oracle = _spmv_both(tiles, rows, cols, x, 3)
    _same_bits(got, oracle)
    _same_bits(got, pallas)


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
def test_fold_by_plan_two_tile_control(reverse):
    """The plain fold that follows a walk plan (chunks of one tile, so
    the two tiles meet in the run's combine)."""
    tiles, rows, cols, x = _two_tile_control(reverse=reverse)
    plan = walk_plan(cols[None], 1, chunk=1)
    got = fold_by_plan(torch.from_numpy(tiles)[None],
                       torch.from_numpy(rows)[None],
                       torch.from_numpy(x)[None], plan, MIN_PLUS)
    _same_bits(got[0], _spmv_both(tiles, rows, cols, x, 1)[2])


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
@pytest.mark.parametrize("comb", [0.0, -0.0, INF, NAN])
def test_fused_ref_two_tile_control(reverse, comb):
    """The fused step's fold and its combine with x_comb (+0 against the
    fold's -0, -0 against it, +inf and NaN), one partition, and its vote
    (-0 and +0 are equal, so a sign alone is no change)."""
    tiles, rows, cols, x = _two_tile_control(reverse=reverse)
    B = tiles.shape[-1]
    args = [tiles[None], rows[None], cols[None], x.reshape(1, 2, B)]
    x_comb = np.full((1, 1, B), comb, np.float32)
    x_ref = np.full((1, 1, B), 0.0, np.float32)
    vmask = np.ones((1, 1, B), bool)
    got, gch = fused_step_ref(*map(torch.from_numpy, args),
                              torch.from_numpy(x_comb),
                              torch.from_numpy(x_ref),
                              torch.from_numpy(vmask), MIN_PLUS)
    for use_pallas in (True, False):
        want, wch = j_fused(*map(jnp.asarray, args), jnp.asarray(x_comb),
                            jnp.asarray(x_ref), jnp.asarray(vmask),
                            J_MIN_PLUS, use_pallas=use_pallas,
                            interpret=True)
        _same_bits(got, want)
        assert np.array_equal(gch.numpy(), np.asarray(wch))


@pytest.mark.parametrize("reverse", [False, True], ids=["ab", "ba"])
@pytest.mark.parametrize("shape", ["sweep", "consume"])
def test_fused_ref_zero_control(shape, reverse):
    """Three partitions of the random ±0 control, as a sweep (x_in is
    x_comb) and as a consume (one x_in shared by the partitions)."""
    parts = [_zero_control(s, reverse=reverse) for s in (4, 5, 6)]
    B = parts[0][0].shape[-1]
    tiles = np.stack([p[0] for p in parts])
    rows = np.stack([p[1] for p in parts])
    cols = np.stack([p[2] for p in parts])
    x = np.stack([p[3] for p in parts]).reshape(3, -1, B)
    x_in = x if shape == "sweep" else x[:1]
    x_ref = np.flip(x, 2).copy()
    vmask = np.ones_like(x, bool)
    got, gch = fused_step_ref(*map(torch.from_numpy, (
        tiles, rows, cols, x_in, x, x_ref, vmask)), MIN_PLUS)
    for use_pallas in (True, False):
        want, wch = j_fused(*map(jnp.asarray, (
            tiles, rows, cols, x_in, x, x_ref, vmask)), J_MIN_PLUS,
            use_pallas=use_pallas, interpret=True)
        _same_bits(got, want)
        assert np.array_equal(gch.numpy(), np.asarray(wch))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zero_env():
    """TR_TINY in both packages, with every latency replaced by +0 or -0
    (unreached edges stay +inf), so that every reached vertex ties."""
    col = generate_collection(TR_TINY)
    t = col.template
    bg = build_blocked(t, partition_graph(t, TR_TINY.num_partitions,
                                          seed=TR_TINY.seed),
                       TR_TINY.block_size)
    jcol = j_generate(J_TR_TINY)
    jt = jcol.template
    jbg = j_build_blocked(jt, j_partition(jt, J_TR_TINY.num_partitions,
                                          seed=J_TR_TINY.seed),
                          J_TR_TINY.block_size)
    I = 4
    lat = np.stack([col.edge_values(i, "latency") for i in range(I)])
    rng = np.random.default_rng(11)
    sign = rng.random(lat.shape) < 0.5
    w = np.where(np.isfinite(lat), np.where(sign, -0.0, 0.0), INF)
    return dict(bg=bg, jbg=jbg, w=w.astype(np.float32))


def _negative_zero_init(sources):
    """The SSSP seed with -0 at each source: x0 is +inf everywhere else
    (one lane per source; a single source gives a rank-2 state)."""

    def init(bg):
        x0 = np.stack([bg.scatter_vertex(
            np.full(bg.part_of.shape, INF, np.float32), INF)
            for _ in sources])
        for q, s in enumerate(sources):
            x0[q, bg.part_of[s], bg.local_of[s]] = -0.0
        return x0 if len(sources) > 1 else x0[0]

    return init


@pytest.mark.parametrize("sources", [[0], [0, 5, 17]], ids=["one", "three"])
@pytest.mark.parametrize("mode", ["off", "spmv", "fused"])
@pytest.mark.parametrize("pattern", ["sequential", "independent"])
def test_engine_with_negative_zero_state(zero_env, sources, mode, pattern):
    """A min-plus engine run whose state and weights are signed zeros:
    values, final state, supersteps and sweeps equal the reference's
    bitwise (the sign included) under every kernel mode."""
    jprog = J.min_plus_program("sssp", init=_negative_zero_init(sources))
    want = J.TemporalEngine(zero_env["jbg"]).run(jprog, zero_env["w"],
                                                 pattern=pattern)
    prog = T.min_plus_program("sssp", init=_negative_zero_init(sources))
    got = T.TemporalEngine(zero_env["bg"], device="cpu",
                           use_pallas=mode).run(prog, zero_env["w"],
                                                pattern=pattern)
    vals = np.asarray(want.values)
    assert np.any(np.signbit(vals) & (vals == 0))  # -0 reached vertices
    assert np.any(~np.signbit(vals) & (vals == 0))  # and so did +0
    _same_bits(got.values, vals)
    _same_bits(got.final, want.final)
    for k in ("supersteps", "local_sweeps"):
        assert np.array_equal(np.asarray(got.stats[k]),
                              np.asarray(want.stats[k]))


def test_negative_zero_control_is_order_dependent_in_torch():
    """The fault the repair removes: torch's own min folds give +0 or -0
    by the order of equal operands (if this ever stops holding, the
    repair is still right, only no longer needed)."""
    a, b = torch.tensor([0.0]), torch.tensor([-0.0])
    signs = {bool(torch.signbit(torch.minimum(a, b))),
             bool(torch.signbit(torch.minimum(b, a)))}
    assert signs == {False, True}
    assert bool(torch.signbit(MIN_PLUS.add(a, b))) and \
        bool(torch.signbit(MIN_PLUS.add(b, a)))
    # the reference's, in both orders
    assert all(bool(jnp.signbit(jnp.minimum(*o))) for o in (
        (jnp.float32(0.0), jnp.float32(-0.0)),
        (jnp.float32(-0.0), jnp.float32(0.0))))
    assert jax.numpy.isnan(J_MIN_PLUS.add(jnp.float32(NAN), jnp.float32(0)))
