"""Kernel K4, the grid-hash 1-NN query (``kernels/grid_query.py``), and the
grid property it relies on.

On the CPU: in every cell of ``grid_hash_build``'s table the filled slots
form a prefix (K4 stops a cell's scan at its first empty slot);
``grid_hash_query`` on CPU tensors runs the plain version and launches
nothing; the wrapper refuses CPU tensors.

Marked ``cuda`` (they skip where torch sees no CUDA device; on a machine
with a card: ``python -m pytest -m cuda tests/test_torch_grid_query.py``):
K4 against the plain version on the card, index and distance bit-equal,
at ICP's shapes in the registration cell (921,600 queries on a
921,600-point target; coarse 64^3 x 16 slots, fine 96^3 x 8), on both
layouts of the table, and at the edges: masked-out queries, queries
beyond the extent or not finite, exact ties from duplicated target points
and from a lattice, cells holding more points than slots, an empty
target, Q = 0 and partial warps; ``grid2_query`` and the compiled ICP
bit-equal to the plain path with the same iterations; the launch counter
after an ICP capture. No JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repas_tpu_torch.cloud import knn, normals  # noqa: E402
from repas_tpu_torch.cloud import registration as reg  # noqa: E402
from repas_tpu_torch.core.jit import clear_caches  # noqa: E402
from repas_tpu_torch.core.transforms import make_T, rodrigues  # noqa: E402
from repas_tpu_torch.kernels import _build  # noqa: E402
from repas_tpu_torch.kernels.grid_query import grid_query  # noqa: E402

ICP_N = 921_600                    # a 1280x720 frame's cloud


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture
def launches():
    """_build.launches["grid_query"] from 0, restored afterwards."""
    saved = _build.launches["grid_query"]
    _build.launches["grid_query"] = 0
    yield _build.launches
    _build.launches["grid_query"] = saved


def _clustered(n, seed, spread=0.5):
    """n points: half uniform over +-spread, half in a few tight clusters
    (cells over capacity)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-spread, spread, (n - n // 2, 3))
    centres = rng.uniform(-spread, spread, (5, 3))
    b = centres[rng.integers(0, 5, n // 2)] + rng.normal(0, 0.01,
                                                         (n // 2, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _bumpy(n, seed, shift=(0.0, 0.0, 0.0)):
    """n points of the registration cell's surface, uniform in x, y."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-0.5, 0.5, (2, n))
    z = 0.08 * np.sin(7 * x + 1.1) * np.cos(5 * y + 0.7) + 0.25 * x * x
    return (np.stack([x, y, z], 1) + np.float32(shift)).astype(np.float32)


def _same(got, want):
    """Indices equal and distances equal bit for bit."""
    return (torch.equal(got[0], want[0])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32)))


# --- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("dims,slots,keep", [
    ((8, 8, 8), 4, 1.0),
    ((16, 16, 16), 8, 0.5),
    ((5, 7, 3), 48, 0.9),
    ((24, 24, 24), 2, 1.0),
    ((12, 12, 12), 6, 0.0),            # nothing masked in
    ((64, 64, 64), 16, 0.7),           # ICP's coarse level
])
def test_filled_slots_form_a_prefix(dims, slots, keep):
    pts = torch.from_numpy(_clustered(6000, seed=slots))
    mask = torch.from_numpy(np.random.default_rng(1).random(6000) < keep)
    gh = knn.grid_hash_build(pts, mask, torch.full((3,), -0.55),
                             1.1 / max(dims), dims, slots)
    filled = gh.cell_of >= 0
    # slot s filled only where slot s-1 is: a prefix in every cell
    assert not bool((filled[1:] & ~filled[:-1]).any())
    # of as many points as the cell holds, up to its slots
    n_cells = dims[0] * dims[1] * dims[2]
    held = torch.bincount(knn._cell_ids(pts, gh.origin, gh.cell, dims)[mask],
                          minlength=n_cells)
    assert torch.equal(filled.sum(0), torch.clamp(held, max=slots))
    if keep:
        full = filled.all(0)
        assert bool(full.any()) and bool((filled.any(0) & ~full).any())


def test_grid_hash_query_on_cpu_runs_the_plain_path(launches):
    tgt = torch.from_numpy(_clustered(3000, seed=2))
    q = torch.from_numpy(_clustered(2500, seed=3))
    tm = torch.ones(3000, dtype=torch.bool)
    qm = torch.from_numpy(np.random.default_rng(4).random(2500) > 0.1)
    gh = knn.grid_hash_build(tgt, tm, torch.full((3,), -0.55), 0.07,
                             (16, 16, 16), 8)
    got = knn.grid_hash_query(gh, tgt, q, qm, (16, 16, 16))
    want = knn.grid_hash_query_plain(gh, tgt, q, qm, (16, 16, 16),
                                     chunk=333)
    assert _same(got, want)
    assert (got[0] >= 0).float().mean() > 0.5
    g2 = knn.grid2_build(tgt, tm, 0.08, coarse_dims=(16, 16, 16),
                         fine_dims=(24, 24, 24))
    knn.grid2_query(g2, tgt, q, qm, (16, 16, 16), (24, 24, 24))
    knn.nearest_neighbors(tgt, tm, q, qm, 0.08, dims=(16, 16, 16))
    assert launches["grid_query"] == 0


def test_grid2_keeps_its_tables_with_slots_together():
    pts = torch.from_numpy(_clustered(4000, seed=5))
    mask = torch.ones(4000, dtype=torch.bool)
    g2 = knn.grid2_build(pts, mask, 0.08, coarse_dims=(16, 16, 16),
                         fine_dims=(24, 24, 24), coarse_slots=6,
                         fine_slots=3)
    for gh, dims, slots in ((g2.coarse, (16, 16, 16), 6),
                            (g2.fine, (24, 24, 24), 3)):
        ref = knn.grid_hash_build(pts, mask, gh.origin, gh.cell, dims, slots)
        assert torch.equal(gh.cell_of, ref.cell_of)
        assert gh.cell_of.stride() == (1, slots)


def test_grid_query_refuses_what_k4_does_not_take():
    gh = knn.grid_hash_build(torch.zeros(4, 3), torch.ones(4, dtype=bool),
                             torch.zeros(3), 0.1, (4, 4, 4), 2)
    q = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        grid_query(gh.cell_of, gh.origin, gh.cell, q, q,
                   torch.ones(3, dtype=bool), (4, 4, 4))


# --- the card --------------------------------------------------------------

def _icp_grids(dev, seed=0):
    """The registration cell's ICP at its shapes: the target, the source
    moved near it (as after RANSAC), and the two-level grid at 1.5 voxel
    (the voxel 2 % of the AABB diagonal, as register_clouds sets it)."""
    tgt = torch.from_numpy(_bumpy(ICP_N, seed)).to(dev)
    src = torch.from_numpy(_bumpy(ICP_N, seed + 1,
                                  (0.002, -0.001, 0.0015))).to(dev)
    mask = torch.ones(ICP_N, dtype=torch.bool, device=dev)
    both = torch.cat([src, tgt])
    voxel = 0.02 * float(torch.linalg.vector_norm(both.amax(0)
                                                  - both.amin(0)))
    return tgt, src, mask, knn.grid2_build(tgt, mask, 1.5 * voxel)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slots_together", "as_built"])
def test_k4_bit_equal_to_plain_at_icp_shapes(dev, launches, layout):
    tgt, src, mask, g2 = _icp_grids(dev)
    for gh, dims, slots in ((g2.coarse, (64, 64, 64), 16),
                            (g2.fine, (96, 96, 96), 8)):
        if layout == "as_built":
            gh = gh._replace(cell_of=gh.cell_of.contiguous())
        assert gh.cell_of.shape[0] == slots
        before = launches["grid_query"]
        got = knn.grid_hash_query.fn(gh, tgt, src, mask, dims)
        assert launches["grid_query"] == before + 1
        want = knn.grid_hash_query_plain(gh, tgt, src, mask, dims)
        torch.cuda.synchronize()
        assert _same(got, want)
        assert bool((got[0] >= 0).all())
        # most cells of the surface hold more points than slots
        filled = (gh.cell_of >= 0).sum(0)
        assert int((filled == slots).sum()) > 0.9 * int((filled > 0).sum())


def _edge_queries(dev):
    """Queries inside, beyond the extent, not finite, some masked out; a
    count that leaves a partial warp."""
    q = torch.from_numpy(_clustered(4097, seed=7)).to(dev)
    q[0] = float("nan")
    q[1, 0] = float("inf")
    q[2, 1] = -float("inf")
    q[3] = 0.6                         # just beyond the extent
    q[4] = -0.6
    q[5] = 50.0                        # far beyond it
    q[6, 2] = float("nan")
    m = torch.ones(4097, dtype=torch.bool, device=dev)
    m[100:160] = False
    m[3] = False
    return q, m


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["overfull_cells", "duplicated_points",
                                  "nothing_masked_in", "slots_together"])
def test_k4_bit_equal_to_plain_at_the_edges(dev, case):
    pts = _clustered(5000, seed=8)
    mask = np.ones(5000, bool)
    slots = 4
    if case == "duplicated_points":
        # each point twice: exact ties inside a cell and across cells
        pts = np.concatenate([pts, pts])
        mask = np.concatenate([mask, mask])
        slots = 6
    elif case == "nothing_masked_in":
        mask[:] = False
    tgt = torch.from_numpy(pts).to(dev)
    tm = torch.from_numpy(mask).to(dev)
    dims = (11, 13, 9)
    gh = knn.grid_hash_build(tgt, tm, torch.tensor([-0.52, -0.5, -0.55]),
                             0.1, dims, slots)
    if case == "slots_together":
        gh = knn._slots_together(gh)
    q, qm = _edge_queries(dev)
    if case == "duplicated_points":
        q[1000:2000] = tgt[:1000]          # queries on duplicated points
    got = knn.grid_hash_query.fn(gh, tgt, q, qm, dims)
    want = knn.grid_hash_query_plain(gh, tgt, q, qm, dims)
    torch.cuda.synchronize()
    assert _same(got, want)
    found = got[0] >= 0
    if case == "nothing_masked_in":
        assert not bool(found.any()) and bool(torch.isinf(got[1]).all())
    else:
        assert float(found.float().mean()) > 0.8
        assert not bool(found[qm.logical_not()].any())
        assert bool(torch.isinf(got[1][qm.logical_not()]).all())
    if case == "duplicated_points":
        # the lower column wins: within a cell the higher index (slot 0
        # holds a cell's highest), here the duplicate at i + 5000
        zero = got[1][1000:2000] == 0
        assert int(zero.sum()) > 500
        assert bool((got[0][1000:2000][zero] >= 5000).all())


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 8])
def test_k4_ties_on_a_lattice_go_to_the_first_column(dev, slots):
    # spacing 1/8: squared distances exact in float32; a query at the
    # centre of 8 lattice points ties across 8 cells, one on a point's
    # duplicate within a cell
    g = np.arange(6, dtype=np.float32) * 0.125
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([lat, lat])
    q = np.concatenate([lat, lat[:125] + 0.0625, lat + 0.03125])
    tgt = torch.from_numpy(pts).to(dev)
    tq = torch.from_numpy(q.astype(np.float32)).to(dev)
    tm = torch.ones(len(pts), dtype=torch.bool, device=dev)
    qm = torch.ones(len(q), dtype=torch.bool, device=dev)
    gh = knn.grid_hash_build(tgt, tm, torch.full((3,), -0.0625), 0.125,
                             (8, 8, 8), slots)
    got = knn.grid_hash_query.fn(gh, tgt, tq, qm, (8, 8, 8))
    want = knn.grid_hash_query_plain(gh, tgt, tq, qm, (8, 8, 8))
    torch.cuda.synchronize()
    assert _same(got, want)
    # ties are there: on the CPU, rows whose least distance repeats
    ghc = knn.grid_hash_build(tgt.cpu(), tm.cpu(), torch.full((3,), -0.0625),
                              0.125, (8, 8, 8), slots)
    _, d2 = knn._candidate_d2(ghc, tgt.cpu(), tq.cpu(), (8, 8, 8))
    ties = (d2 == d2.min(1, keepdim=True).values).sum(1) > 1
    assert int(ties.sum()) >= 125


@pytest.mark.cuda
def test_k4_empty_target_and_no_queries(dev, launches):
    dims = (4, 5, 6)
    empty = torch.zeros((0, 3), device=dev)
    # what grid_hash_build makes of no points
    gh = knn.GridHash(torch.full((4, 120), -1, dtype=torch.int32,
                                 device=dev),
                      torch.zeros(3, device=dev),
                      torch.full((), 0.1, device=dev))
    q, qm = _edge_queries(dev)
    # the plain version cannot index a target of no rows; K4 reads none
    idx, dist = knn.grid_hash_query.fn(gh, empty, q, qm, dims)
    torch.cuda.synchronize()
    assert bool((idx == -1).all()) and bool(torch.isinf(dist).all())
    assert launches["grid_query"] == 1
    tgt = torch.rand((50, 3), device=dev)
    gh = knn.grid_hash_build(tgt, torch.ones(50, dtype=torch.bool,
                                             device=dev),
                             torch.zeros(3), 0.25, dims, 4)
    idx, dist = knn.grid_hash_query.fn(
        gh, tgt, torch.zeros((0, 3), device=dev),
        torch.zeros(0, dtype=torch.bool, device=dev), dims)
    assert idx.shape == (0,) and dist.shape == (0,)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert launches["grid_query"] == 1               # nothing launched


@pytest.mark.cuda
def test_k4_refuses_what_it_does_not_take(dev):
    gh = knn.grid_hash_build(torch.zeros(4, 3, device=dev),
                             torch.ones(4, dtype=bool, device=dev),
                             torch.zeros(3), 0.1, (4, 4, 4), 2)
    q = torch.zeros(3, 3, device=dev)
    m = torch.ones(3, dtype=bool, device=dev)
    args = [gh.cell_of, gh.origin, gh.cell, q, q, m]
    for i, bad, what in ((3, q.double(), "target"),
                         (4, torch.zeros(3, 6, device=dev)[:, ::2], "query"),
                         (5, m.int(), "query_mask"),
                         (0, gh.cell_of[:, :10], "cell_of"),
                         (3, q.cpu(), "device")):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError, match=what):
            grid_query(*a, (4, 4, 4))


@pytest.fixture
def plain_on_card(monkeypatch):
    """Call it to send grid_hash_query's card path through the plain
    version; every captured graph is dropped then and afterwards."""
    def route():
        clear_caches()
        monkeypatch.setattr(knn, "grid_query",
                            lambda co, o, c, t, q, m, dims:
                            knn.grid_hash_query_plain(
                                knn.GridHash(co, o, c), t, q, m, dims))
    yield route
    clear_caches()


@pytest.mark.cuda
def test_grid2_query_bit_equal_to_plain(dev, plain_on_card):
    tgt, src, mask, g2 = _icp_grids(dev, seed=3)
    got = knn.grid2_query(g2, tgt, src, mask)
    plain_on_card()
    want = knn.grid2_query(g2, tgt, src, mask)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_compiled_icp_bit_equal_to_plain_path(dev, plain_on_card, launches,
                                              masked):
    n = 30000
    tgt = torch.from_numpy(_bumpy(n, 11)).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    R = rodrigues(torch.tensor([0.02, -0.03, 0.05]))
    t = torch.tensor([0.01, -0.02, 0.015])
    src = ((torch.from_numpy(_bumpy(n, 12)) - t) @ R).to(dev).contiguous()
    smask = mask.clone()
    if masked:
        smask[::50] = False              # NaN RMSE: runs to max_iters
    nrm, _ = normals.estimate_normals_grid(tgt, mask, k=16, radius=0.03)
    T_init = make_T(R, t).numpy()

    def icp():
        return reg.icp_point_to_plane(src, smask, tgt, mask, nrm,
                                      max_corr_dist=0.03, max_iters=12,
                                      T_init=T_init)

    reg._icp.clear()
    icp()                                               # captures
    assert launches["grid_query"] > 0
    got = icp()
    plain_on_card()
    launches["grid_query"] = 0
    icp()                                               # captures
    want = icp()
    assert launches["grid_query"] == 0
    assert got.iterations == want.iterations
    assert (got.iterations == 12) == masked
    assert torch.equal(got.T, want.T)
    assert torch.equal(got.fitness, want.fitness)
