"""Shared helpers of the port's tests (tests/test_torch_*.py). Imports no JAX,
so the card-only tests that use it run where JAX is not installed."""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread for a module's tests (a module that imports
    this fixture uses it). The suite runs six workers at once on a host of a
    few cores, and a CPU op split over threads that other workers hold waits
    on them: the phase-C tests took 197 s alone at 8 threads and 83 s at
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def leave_nan_blocks(device, *shapes):
    """Frees NaN-filled blocks of these shapes, and keeps no other free block:
    the caching allocator hands them to the next allocations of those sizes,
    so an output a kernel must write in full shows any element it left
    unwritten."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(sh, float("nan"), device=device) for sh in shapes]
    del blocks


def packed_tiles(t=4, k=64, c=3, seed=0, tiles_x=2, tile=16):
    """Depth-sorted packed rows ``(t, k, 7 + c)`` around each tile, with a live
    prefix per tile; returns (packed, counts, live) as numpy. The tiles sit
    near the origin: the Pallas kernel's expanded power (px^2, px py, ...
    monomials) loses digits as px grows, and a flip of the 1/255 skip test
    would then show as a difference of the reference."""
    rng = np.random.default_rng(seed)
    ty, tx = np.divmod(np.arange(t), tiles_x)
    x = tx[:, None] * tile + rng.uniform(-4, tile + 4, (t, k))
    y = ty[:, None] * tile + rng.uniform(-4, tile + 4, (t, k))
    s = rng.uniform(0.05, 0.5, (t, k))
    conic = np.stack([s, rng.uniform(-0.3, 0.3, (t, k)) * s, s * rng.uniform(0.5, 1.5, (t, k))], -1)
    op = rng.uniform(0.1, 1.0, (t, k, 1))           # some alphas hit the .99 clamp
    col = rng.uniform(0, 1, (t, k, c))
    dep = np.sort(rng.uniform(1, 5, (t, k)), 1)[..., None]
    packed = np.concatenate([x[..., None], y[..., None], conic, op, col, dep], -1).astype(np.float32)
    counts = rng.integers(0, k + 1, (t,)).astype(np.int32)
    counts[0], counts[1] = k, 0
    live = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    return packed, counts, live


EDGE_CASES = ("full", "clamp", "tmin", "shared")


def edge_tiles(case, c=3, seed=0, shared_tiles_x=8):
    """Packed tiles for the rasterizer kernels' edge cases, gathered from n
    per-Gaussian rows: ``packed = rows[gid]``. Returns (packed (t, k, 7 + c),
    counts (t,), gid (t, k) int64, n, tiles_x) as numpy; the tiles are 16 x
    16 near the origin, as in ``packed_tiles``.

    - ``full``: K 512, one tile at full capacity, one empty, counts 333 and
      77 (no multiple of 32 or 64), faint splats (opacity 0.02-0.3) so that
      T stays above 1e-4 deep into the full tile;
    - ``clamp``: opacity 1 for every other Gaussian, centred on a pixel, so
      alpha sits at the 0.99 clamp there;
    - ``tmin``: flat splats (conic 0) of alpha 0.18-0.22 over the whole tile,
      so T crosses 1e-4 inside the second checkpoint window (slot ~41 of 128)
      at every pixel at once, well clear of 1e-4 at each slot;
    - ``shared``: 8 x 8 tiles (the dup 8 x 8 spread; ``shared_tiles_x`` x
      ``shared_tiles_x`` in general) holding one Gaussian in every tile, and
      ids repeated inside a tile.
    """
    rng = np.random.default_rng(seed)
    tiles_x, k, n = 2, 64, 80
    counts = [64, 0, 45, 19]
    if case == "full":
        k, n, counts = 512, 700, [512, 0, 333, 77]
    elif case == "tmin":
        k, n, counts = 128, 150, [128, 0, 70, 41]
    elif case == "shared":
        tiles_x, k, n = shared_tiles_x, 32, 90
        counts = list(rng.integers(1, k + 1, tiles_x * tiles_x))
        counts[:3] = [k, 0, 31]
    elif case != "clamp":
        raise ValueError(case)
    t = len(counts)
    span_x, span_y = tiles_x * 16, -(-t // tiles_x) * 16
    x = rng.uniform(-4, span_x + 4, n)
    y = rng.uniform(-4, span_y + 4, n)
    s = rng.uniform(0.05, 0.5, n)
    conic = np.stack([s, rng.uniform(-0.3, 0.3, n) * s, s * rng.uniform(0.5, 1.5, n)], -1)
    op = rng.uniform(0.1, 1.0, n)
    if case == "full":
        op = rng.uniform(0.02, 0.3, n)
    elif case == "clamp":
        x[::2], y[::2] = np.round(x[::2]), np.round(y[::2])
        conic[::2] = [0.02, 0.0, 0.02]      # the centre and its 4 neighbours clamp
        op[::2] = 1.0
    elif case == "tmin":
        conic = np.zeros((n, 3))   # alpha = opacity at every pixel
        op = rng.uniform(0.18, 0.22, n)
    elif case == "shared":
        x[0], y[0], conic[0] = span_x / 2, span_y / 2, [4e-4, 0.0, 4e-4]
    rows = np.concatenate([x[:, None], y[:, None], conic, op[:, None],
                           rng.uniform(0, 1, (n, c)), rng.uniform(1, 5, (n, 1))], -1)
    gid = np.stack([rng.choice(n, k, replace=False) for _ in range(t)])
    if case == "shared":
        gid[:, 0] = 0                       # one Gaussian in all 64 tiles
        gid[:, 5:9] = gid[:, 4:5]           # and an id four more times inside a tile
    packed = rows[gid]
    packed[..., -1] = np.sort(packed[..., -1], 1)  # depth order within each tile
    return (packed.astype(np.float32), np.asarray(counts, np.int32), gid.astype(np.int64), n,
            tiles_x)


def threshold_tiles(c=3, seed=0, tiles_x=8, k=64, front=8):
    """Packed 16 x 16 tiles (tiles_x x tiles_x of them, k live slots each) whose
    slots after the first ``front`` sit at the edge of the forward's box test:
    an axis-aligned splat just outside a corner of one warp's pixel box (a
    tile's 16 columns x 4 rows), its opacity set so that its alpha at that
    corner pixel is 1/255 to within -3e-7..6e-7 relative. Whether it draws
    there is decided by the last rounding, so a box test that cut its margin
    would skip some slots that draw. The ``front`` slots are broad faint
    splats over the tile. Returns (packed (t, k, 7 + c), counts (t,),
    tiles_x) as numpy; no plain version agrees with the kernel on every
    threshold slot (torch's exp rounds differently), so only the kernel with
    and without its skip are held to each other."""
    rng = np.random.default_rng(seed)
    t = tiles_x * tiles_x
    ty, tx = np.divmod(np.arange(t), tiles_x)
    rows = np.zeros((t, k, 7 + c))
    # the broad front splats: centred in the tile, alpha 0.05-0.3
    rows[:, :front, 0] = tx[:, None] * 16 + rng.uniform(2, 14, (t, front))
    rows[:, :front, 1] = ty[:, None] * 16 + rng.uniform(2, 14, (t, front))
    s = rng.uniform(0.002, 0.02, (t, front))
    rows[:, :front, 2], rows[:, :front, 4] = s, s * rng.uniform(0.5, 1.5, (t, front))
    rows[:, :front, 5] = rng.uniform(0.05, 0.3, (t, front))
    # the threshold splats: a corner of warp w's box, the centre dx, dy beyond it
    n = k - front
    warp = rng.integers(0, 4, (t, n))
    right, below = rng.random((t, n)) < 0.5, rng.random((t, n)) < 0.5
    dx, dy = rng.uniform(0.5, 3, (t, n)), rng.uniform(0.5, 3, (t, n))
    ca = rng.uniform(0.05, 0.5, (t, n))
    cc = ca * rng.uniform(0.5, 1.5, (t, n))
    corner_x = tx[:, None] * 16 + np.where(right, 15, 0)
    corner_y = ty[:, None] * 16 + 4 * warp + np.where(below, 3, 0)
    x = corner_x + np.where(right, dx, -dx)
    y = corner_y + np.where(below, dy, -dy)
    q = ca * (x - corner_x) ** 2 + cc * (y - corner_y) ** 2
    op = np.exp(0.5 * q) / 255 * (1 + rng.uniform(-3e-7, 6e-7, (t, n)))
    keep = op <= 1.0                        # else a weaker splat, far from the edge
    rows[:, front:, 0], rows[:, front:, 1] = x, y
    rows[:, front:, 2], rows[:, front:, 4] = ca, cc
    rows[:, front:, 5] = np.where(keep, op, 0.01)
    rows[..., 6:6 + c] = rng.uniform(0, 1, (t, k, c))
    rows[..., 6 + c] = np.sort(rng.uniform(1, 5, (t, k)), 1)
    return rows.astype(np.float32), np.full(t, k, np.int32), tiles_x


# The gas-loss density's and the splat adjoint's edge cases (csrc/pbf.cu,
# csrc/splat.cu): points at h = 1 in grids of 512 rows.
ISOLATED_GRIDS = {32: (900, 3.0), 128: (1500, 2.0)}   # M: (points, box edge)


def isolated_point_grid(m, device, seed, coincident=False):
    """Seeded points in a box with full rows at M = ``m`` (32: 900 points in a
    3-unit box, 128: 1500 in a 2-unit box, ~10 % dead), so a row's
    neighbourhood list spans several of the kernels' staged chunks, and
    point 0 alone 5.5 units past the box: its 26 neighbour cells are empty.
    With ``coincident``, points 1 and 2 are live and share their coordinates
    (two slots of one row at d2 = 0 that are not a self pair). Returns
    (grid, rng), the generator left for the caller's next draws."""
    from fluidnexus_torch.ops.neighbors import build_dense_grid

    n, box = ISOLATED_GRIDS[m]
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, box, (n, 3))
    pts[0] = box + 5.5
    alive = rng.random(n) > 0.1
    alive[0] = True
    if coincident:
        pts[2] = pts[1]
        alive[1:3] = True
    grid = build_dense_grid(torch.as_tensor(pts.astype(np.float32), device=device), 1.0,
                            torch.as_tensor(alive, device=device), 512, m)
    return grid, rng


def coincident_pairs_grid(m, device, seed, pairs=20):
    """Seeded points in a box with full rows at M = ``m`` (``ISOLATED_GRIDS``,
    ~10 % dead) where points 2j + 1 sit on points 2j for j < ``pairs``, all
    live: non-self pairs at d2 = 0 in many rows. At the default epsilon such
    a pair's cg is ~1e5 and its terms in sg = (sum cg) x_i - sum cg x_s
    cancel, so only the rounding of sums that hold them (and take the self
    pair by index, in the walk's order) reproduces the bits. Returns (grid,
    rng), the generator left for the caller's next draws."""
    from fluidnexus_torch.ops.neighbors import build_dense_grid

    n, box = ISOLATED_GRIDS[m]
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, box, (n, 3))
    alive = rng.random(n) > 0.1
    pts[1:2 * pairs:2] = pts[0:2 * pairs:2]
    alive[:2 * pairs] = True
    grid = build_dense_grid(torch.as_tensor(pts.astype(np.float32), device=device), 1.0,
                            torch.as_tensor(alive, device=device), 512, m)
    return grid, rng


def graded_rows_grid(m, device, seed, edge=5):
    """Seeded points on an ``edge``^3 block of unit cells (h = 1) whose live
    counts cover every band the row-group kernels deal differently: 1-8, 9-16,
    17-24 and 25-32 live slots a row, and at M = ``m`` = 128 also 33-64 and
    65-128 (``GRADED_BANDS``), a band drawn for each cell and a count in it.
    About 10 % more points are dead, the first point of 20 cells has a live
    twin at its coordinates (non-self pairs at d2 = 0 in one row), and one
    point sits alone 5.5 units past the block, so its 26 neighbour cells are
    empty. Rows of one warp hold counts of different bands, and a row's
    neighbourhood list spans more than one staged chunk of 256 entries.
    Returns (grid, rng), the generator left for the caller's next draws."""
    from fluidnexus_torch.ops.neighbors import build_dense_grid

    rng = np.random.default_rng(seed)
    bands = [b for b in GRADED_BANDS if b[1] <= m]
    cells = np.stack(np.meshgrid(*[np.arange(edge)] * 3, indexing="ij"), -1).reshape(-1, 3)
    counts = [int(rng.integers(lo, hi + 1)) for lo, hi in
              (bands[i] for i in rng.integers(0, len(bands), len(cells)))]
    pts = np.concatenate([c + rng.uniform(0.01, 0.99, (n, 3)) for c, n in zip(cells, counts)])
    starts = np.cumsum([0] + counts[:-1])
    twins = [s for s, n in zip(starts, counts) if n >= 2][:20]
    pts[np.array(twins) + 1] = pts[twins]
    dead = rng.uniform(0, edge, (len(pts) // 10, 3))
    lone = np.full((1, 3), edge + 5.5)
    alive = np.concatenate([np.ones(len(pts), bool), np.zeros(len(dead), bool), [True]])
    xyz = np.concatenate([pts, dead, lone]).astype(np.float32)
    order = rng.permutation(len(xyz) - 1)
    xyz[:-1], alive[:-1] = xyz[:-1][order], alive[:-1][order]
    grid = build_dense_grid(torch.as_tensor(xyz, device=device), 1.0,
                            torch.as_tensor(alive, device=device), 512, m)
    return grid, rng


GRADED_BANDS = ((1, 8), (9, 16), (17, 24), (25, 32), (33, 64), (65, 128))


def guarded_gather(nbr, cnt, x, y, z, lam, guard=16):
    """The v1 pre-gather (``pbf_cuda.gather_v1``, ``gather_lam_v1``) as the
    first C rows of tensors with ``guard`` more rows past them, which hold a
    full row's count at every neighbour, coordinates of 0.5 and lambdas of 1:
    a kernel that reads the gathered rows of row C or past (they have none)
    finds live neighbours in reach of row C's slots there, and its outputs
    show it. Returns (ncnt, xng,
    lng), each contiguous."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    ncnt, xng = pc.gather_v1(nbr, cnt, x, y, z)
    lng = pc.gather_lam_v1(nbr, lam)
    c, m = ncnt.shape[0], x.shape[1]
    out = []
    for t, fill in ((ncnt, m), (xng, 0.5), (lng, 1.0)):
        g = torch.full((c + guard,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
        g[:c] = t
        out.append(g[:c])
    return tuple(out)


def phase1_against_the_walk(grid, imass, k):
    """Phase 1 v3 (row 12), phase 1 v2 (row 6) and phase 1 v1 (row 4) against
    phase 1 v1's checking mode (``phase1_v1_slots(..., walk=True)``), the
    one-block-a-row walk that takes the self pair by index and sums each
    slot's pairs in the order the row groups keep, over ``grid``'s v1
    pre-gather followed by guard rows (``guarded_gather``: a kernel whose row
    C reads gathered rows it has none of shows in its outputs), with per-slot
    inverse masses ``imass`` and pair constants ``k``: (row 12's pi_raw bit
    for bit, its nl equal to nlen, the largest
    relative difference over the live slots of its lambda from lambda formed
    from the walk's sums, p_ratio in f32 as the kernel forms it and the rest
    in f64; rows 6's and 4's pi_raw, sg, c2d2 and nlen each bit for bit). With
    the same sums only row 12's f32 epilogue over positive terms parts it
    from the walk's, a few ulp; rows 6 and 4 write the walk's own
    expressions."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    cnt, *xyz = pc.planes(grid)
    ncnt, xng, _ = guarded_gather(grid.nbr, cnt, *xyz, torch.zeros_like(xyz[0]))
    walk = pc.phase1_v1_slots(ncnt, xng, *xyz, k, walk=True)
    lam, pi_raw, nl, _, _ = pc.phase1_slots(grid.nbr, cnt, *xyz, imass, k)
    raw = pc.phase1_v2_slots(grid.nbr, cnt, *xyz, k)
    row4 = pc.phase1_v1_slots(ncnt, xng, *xyz, k)
    pi2, sg, c2d2, nlen = walk[:4]
    p_ratio = (pi2 / imass * k.inv_p0).double()
    ip2 = k.inv_p0 ** 2
    ref = -(p_ratio - 1.0) / (c2d2.double() * ip2 + (sg.double() ** 2).sum(-1) * ip2 + k.relax)
    rel = ((lam.double() - ref).abs() / ref.abs().clamp(min=1e-30))[grid.bmask]
    return (torch.equal(pi_raw.view(torch.int32), pi2.view(torch.int32)), torch.equal(nl, nlen),
            float(rel.max()),
            [torch.equal(a.view(torch.int32), b.view(torch.int32))
             for got in (raw, row4) for a, b in zip(got[:4], walk[:4])])


def phase2_part(mod, name, args):
    """Phase 2 v3 (``name`` pbf_phase2, ``args`` (nbr, cnt, x, y, z, lam, nc,
    k)), v2 (pbf_phase2_v2, (nbr, cnt, x, y, z, lam, k)) or v1 (pbf_phase2_v1,
    (ncnt, xng, lng, x, y, z, lam, k)) through the C entry of ``mod`` (a
    ``pbf_cuda`` module, this checkout's or another's) with the arguments its
    wrapper passes: (the updated planes x, y, z, or dsum, then the per-row
    partial sums (C+1, 2) of s_corr and s_ns, which the wrapper adds up)."""
    k = args[-1]
    consts = [k.h, k.h2, k.eps, k.c6, k.s45, k.k_p, k.e_p, k.int_pow, k.inv_denom]
    if name == "pbf_phase2_v1":
        ncnt, xng, lng, x, y, z, lam = args[:7]
        ptrs = [ncnt.data_ptr(), xng.data_ptr(), lng.data_ptr(), x.data_ptr(), y.data_ptr(),
                z.data_ptr(), lam.data_ptr()]
    else:
        nbr, cnt, x, y, z, lam = args[:6]
        ptrs = [cnt.data_ptr(), nbr.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
                lam.data_ptr()]
    c, m = x.shape[0] - 1, x.shape[1]
    part = torch.empty((c + 1, 2), dtype=torch.float32, device=x.device)
    if name == "pbf_phase2":
        out = tuple(torch.empty_like(x) for _ in range(3))
        err = mod._lib().fnx_pbf_phase2(
            *ptrs, args[6].data_ptr(), *(o.data_ptr() for o in out), part.data_ptr(), c, m,
            *consts, k.inv_p0, mod._stream(x))
    else:
        out = (torch.empty(x.shape + (3,), dtype=torch.float32, device=x.device),)
        entry = mod._lib().fnx_pbf_phase2_v1 if name == "pbf_phase2_v1" else \
            mod._lib().fnx_pbf_phase2_v2
        err = entry(*ptrs, out[0].data_ptr(), part.data_ptr(), c, m, *consts, mod._stream(x))
    if err:
        raise RuntimeError(f"{name}'s C entry returned {err}")
    return out + (part,)


def plain_row_partials(nbr, cnt, x, y, z, lam, k, gathered=None):
    """The per-row partial sums (C+1, 2) of s_corr and s_ns over each row's
    live slots that phase 2 (v3, v2, or v1 with ``gathered`` = (ncnt, xng,
    lng) and ``nbr`` = ncnt) writes, from its plain version's sums (summed in
    another order than the kernel's tree)."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    rows, mu = pc._extent(nbr, cnt)
    _, _, cra, nsa = pc._phase2_sums(nbr, cnt, (x, y, z), lam, k, rows, mu, gathered)
    live = pc._live(cnt, mu)[:rows]
    part = torch.zeros((cnt.numel(), 2), device=x.device)
    part[:rows, 0] = torch.where(live, cra, 0.0).sum(1)
    part[:rows, 1] = torch.where(live, nsa, 0.0).sum(1)
    return part


SPLAT_QUERIES = {32: (1200, 3.0), 128: (1800, 2.0)}  # source capacity: queries, their box


def _splat_sets(ms, pile, device, seed, far_sources):
    """The seeded sets of ``splat_edge_args``: sources in a box with full
    rows at capacity ``ms`` (``ISOLATED_GRIDS``); queries packed into the
    same box (``SPLAT_QUERIES``), ``pile`` more within 0.1 of (0.5, 0.5, 0.5),
    one cell of h = 1; and, with none of the other set among their 27
    neighbour cells, 60 more sources 4-5.5 units past the box
    (``far_sources``) or a sheet of 36 x 36 queries one to a cell 4.5 units
    above it (so the query list has over 1 024 occupied rows, past one tile
    of the forward's chunk scan). The query list takes 2 048 rows. About 10 %
    of either set is dead, none of the pile. Returns (grid, query list, the
    source velocities, rng)."""
    from fluidnexus_torch.ops.neighbors import build_dense_grid, slot_gather, sort_queries

    n, box = ISOLATED_GRIDS[ms]
    nq, qbox = SPLAT_QUERIES[ms]
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, box, (n, 3))
    qry = np.concatenate([rng.uniform(0, min(box, qbox), (nq, 3)),
                          0.5 + rng.uniform(-0.1, 0.1, (pile, 3))])
    if far_sources:
        src = np.concatenate([src, rng.uniform(box + 4, box + 5.5, (60, 3))])
    else:
        i, k = np.meshgrid(np.arange(36) + 0.5, np.arange(36) + 0.5)
        qry = np.concatenate([qry, np.stack([i.ravel(), np.full(i.size, box + 4.5), k.ravel()],
                                            -1)])
    alive = rng.random(len(src)) > 0.1
    q_alive = rng.random(len(qry)) > 0.1
    q_alive[nq:nq + pile] = True

    def t(a):
        return torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64 else a, device=device)

    grid = build_dense_grid(t(src), 1.0, t(alive), 512, ms)
    ql = sort_queries(grid, 1.0, t(qry), t(q_alive), 2048)
    vel = slot_gather(grid, t(rng.normal(size=(len(src), 3)))).contiguous()
    return grid, ql, vel, rng


def splat_edge_args(ms, pile, device, seed):
    """The splat adjoint's arguments for its edge cases, at source capacity
    ``ms`` (32 or 128) with a pile of ``pile`` queries in one cell
    (``_splat_sets``, the far cluster of sources): full source rows, source
    rows with no query in reach, query lists that span more than one staged
    chunk, and with a pile of 300 a source row's list of over 300 entries.
    Returns (rnbr, scnt, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, h),
    p (Nq, 3) and q (Nq,) seeded per list entry."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    grid, ql, vel, rng = _splat_sets(ms, pile, device, seed, far_sources=True)
    nq = ql.x.shape[0]
    p = torch.as_tensor(rng.normal(size=(nq, 3)).astype(np.float32), device=device)
    q = torch.as_tensor(rng.normal(size=nq).astype(np.float32), device=device)
    return (ql.rnbr, *pc.planes(grid), vel, ql.start, ql.cnt, ql.x, ql.y, ql.z, p, q, 1.0)


def splat_fwd_edge_args(ms, pile, device, seed):
    """The splat forward's arguments for its edge cases, at source capacity
    ``ms`` (32 or 128) with a pile of ``pile`` queries in one cell
    (``_splat_sets``, the sheet of queries): full source rows, so a query
    row's list of sources spans more than one staged chunk, over 1 024 query
    rows with no source in reach, and with a pile of 300 a query row of ten
    32-query chunks. Returns (qnbr, qstart, qcnt, xq, yq, zq, scnt, xs, ys,
    zs, vel, h)."""
    from fluidnexus_torch.sim import pbf_cuda as pc

    grid, ql, vel, _ = _splat_sets(ms, pile, device, seed, far_sources=False)
    return (ql.nbr, ql.start, ql.cnt, ql.x, ql.y, ql.z, *pc.planes(grid), vel, 1.0)


def listed_mask(qstart, qcnt, nq):
    """(Nq+1,) bool: the list entries that lie in a query row."""
    from fluidnexus_torch.sim.splat_cuda import listed_entries

    mask = torch.zeros(nq + 1, dtype=torch.bool, device=qcnt.device)
    mask[listed_entries(qstart, qcnt, torch.arange(qcnt.numel() - 1, device=qcnt.device))[0]] = True
    return mask


# ------------------- the reference's torch checkpoint layouts -------------------
# Writers of the state dicts that ``diffusion/port.py``'s maps read, each the
# mirror of its map: given a port module's parameters ({dotted flax name:
# tensor in the torch layout}), the reference-named dict whose map gives
# those parameters back. Tensors stay where they are (CPU or card).


def seeded_fill_(module, generator):
    """Every float parameter of ``module`` drawn from ``generator``: a
    weight of rank >= 2 normal / sqrt(its fan-in), a 1-d ``scale``/``weight``
    1 + 0.05 normal, any other 1-d 0.05 normal."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if not p.is_floating_point():
                continue
            z = torch.randn(p.shape, generator=generator, device=p.device)
            if p.dim() >= 2:
                z = z / float(np.sqrt(p[0].numel()))
            elif name.split(".")[-1] in ("scale", "weight") or name.endswith("_scale"):
                z = 1 + 0.05 * z
            else:
                z = 0.05 * z
            p.copy_(z.to(p.dtype))
    return module


def sub_params(named, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in named.items() if k.startswith(prefix)}


def unet_reference_sd(p, cfg):
    """openaimodel UNetModel keys (``port_zero123_unet``'s input)."""
    sd = {}

    def pair(tp, fp, w="weight", b="bias"):
        sd[tp + ".weight"] = p[f"{fp}.{w}"]
        if f"{fp}.{b}" in p:
            sd[tp + ".bias"] = p[f"{fp}.{b}"]

    def gn(tp, fp):
        pair(tp, fp + ".GroupNorm_0", "scale")

    def resblock(tp, fp):
        gn(tp + ".in_layers.0", fp + ".GroupNorm32_0")
        pair(tp + ".in_layers.2", fp + ".conv1")
        pair(tp + ".emb_layers.1", fp + ".emb_proj")
        gn(tp + ".out_layers.0", fp + ".GroupNorm32_1")
        pair(tp + ".out_layers.3", fp + ".conv2")
        if fp + ".skip.weight" in p:
            pair(tp + ".skip_connection", fp + ".skip")

    def spatial(tp, fp):
        gn(tp + ".norm", fp + ".GroupNorm32_0")
        pair(tp + ".proj_in", fp + ".proj_in")
        pair(tp + ".proj_out", fp + ".proj_out")
        for i in range(cfg.transformer_depth):
            tb, fb = f"{tp}.transformer_blocks.{i}", f"{fp}.block_{i}"
            for k in (1, 2, 3):
                pair(f"{tb}.norm{k}", f"{fb}.LayerNorm_{k - 1}", "scale")
            for a in ("attn1", "attn2"):
                for x in ("to_q", "to_k", "to_v"):
                    pair(f"{tb}.{a}.{x}", f"{fb}.{a}.{x}")
                pair(f"{tb}.{a}.to_out.0", f"{fb}.{a}.to_out")
            pair(tb + ".ff.net.0.proj", fb + ".ff_in")
            pair(tb + ".ff.net.2", fb + ".ff_out")

    pair("time_embed.0", "time_fc1")
    pair("time_embed.2", "time_fc2")
    pair("input_blocks.0.0", "conv_in")
    gn("out.0", "GroupNorm32_0")
    pair("out.2", "conv_out")
    attn_res, n = set(cfg.attention_resolutions), len(cfg.channel_mult)
    k, ds = 1, 1
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            resblock(f"input_blocks.{k}.0", f"down_{i}_res_{j}")
            if ds in attn_res:
                spatial(f"input_blocks.{k}.1", f"down_{i}_attn_{j}")
            k += 1
        if i != n - 1:
            pair(f"input_blocks.{k}.0.op", f"down_{i}_downsample")
            k, ds = k + 1, ds * 2
    resblock("middle_block.0", "mid_res_1")
    spatial("middle_block.1", "mid_attn")
    resblock("middle_block.2", "mid_res_2")
    k = 0
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            resblock(f"output_blocks.{k}.0", f"up_{i}_res_{j}")
            idx = 1
            if ds in attn_res:
                spatial(f"output_blocks.{k}.{idx}", f"up_{i}_attn_{j}")
                idx += 1
            if i != 0 and j == cfg.num_res_blocks:
                pair(f"output_blocks.{k}.{idx}.conv", f"up_{i}_upsample")
                ds //= 2
            k += 1
    return sd


def kl_vae_reference_sd(p, cfg):
    """SD AutoencoderKL keys (``port_kl_vae``'s input)."""
    sd = {}

    def pair(tp, fp, w="weight"):
        sd[tp + ".weight"], sd[tp + ".bias"] = p[f"{fp}.{w}"], p[fp + ".bias"]

    def res(tp, fp):
        pair(tp + ".norm1", fp + ".GroupNorm_0", "scale")
        pair(tp + ".conv1", fp + ".conv1")
        pair(tp + ".norm2", fp + ".GroupNorm_1", "scale")
        pair(tp + ".conv2", fp + ".conv2")
        if fp + ".nin_shortcut.weight" in p:
            pair(tp + ".nin_shortcut", fp + ".nin_shortcut")

    def attn(tp, fp):
        pair(tp + ".norm", fp + ".GroupNorm_0", "scale")
        for x in ("q", "k", "v", "proj_out"):
            pair(f"{tp}.{x}", f"{fp}.{x}")

    n = len(cfg.ch_mult)
    for side, blocks in (("encoder", cfg.num_res_blocks), ("decoder", cfg.num_res_blocks + 1)):
        pair(f"{side}.conv_in", f"{side}.conv_in")
        res(f"{side}.mid.block_1", f"{side}.mid_block_1")
        attn(f"{side}.mid.attn_1", f"{side}.mid_attn")
        res(f"{side}.mid.block_2", f"{side}.mid_block_2")
        pair(f"{side}.norm_out", f"{side}.GroupNorm_0", "scale")
        pair(f"{side}.conv_out", f"{side}.conv_out")
        way, sample = ("down", "downsample") if side == "encoder" else ("up", "upsample")
        for i in range(n):
            for j in range(blocks):
                res(f"{side}.{way}.{i}.block.{j}", f"{side}.{way}_{i}_block_{j}")
            if (side == "encoder" and i != n - 1) or (side == "decoder" and i != 0):
                pair(f"{side}.{way}.{i}.{sample}.conv", f"{side}.{way}_{i}_{sample}")
    pair("quant_conv", "quant_conv")
    pair("post_quant_conv", "post_quant_conv")
    return sd


def clip_reference_sd(p, layers):
    """OpenAI CLIP ``visual.*`` keys (``port_openai_clip_visual``'s input)."""
    sd = {"conv1.weight": p["patch_embed.weight"], "class_embedding": p["class_embedding"],
          "positional_embedding": p["positional_embedding"], "proj": p["proj"]}
    for name in ("ln_pre", "ln_post"):
        sd[name + ".weight"], sd[name + ".bias"] = p[name + ".scale"], p[name + ".bias"]
    for i in range(layers):
        tb = f"transformer.resblocks.{i}"
        for k in (1, 2):
            sd[f"{tb}.ln_{k}.weight"] = p[f"ln{k}_{i}.scale"]
            sd[f"{tb}.ln_{k}.bias"] = p[f"ln{k}_{i}.bias"]
        sd[tb + ".attn.in_proj_weight"] = p[f"attn_{i}.qkv.weight"]
        sd[tb + ".attn.in_proj_bias"] = p[f"attn_{i}.qkv.bias"]
        sd[tb + ".attn.out_proj.weight"] = p[f"attn_{i}.out.weight"]
        sd[tb + ".attn.out_proj.bias"] = p[f"attn_{i}.out.bias"]
        for x, y in (("c_fc", "mlp_fc"), ("c_proj", "mlp_proj")):
            sd[f"{tb}.mlp.{x}.weight"] = p[f"{y}_{i}.weight"]
            sd[f"{tb}.mlp.{x}.bias"] = p[f"{y}_{i}.bias"]
    return sd


def zero123_reference_sd(model, upstream_4ch=True):
    """A Lightning ``LatentDiffusion`` state dict (``model.diffusion_model.``,
    ``first_stage_model.``, ``cond_stage_model.model.visual.``,
    ``cc_projection.``) of a port ``NovelViewModel``. With ``upstream_4ch``
    the UNet's input conv keeps its first 4 input channels, as the upstream
    zero123-xl checkpoint has it (the map pads the other 4 with zeros)."""
    named = dict(model.named_parameters())
    sd = {}
    unet = unet_reference_sd(sub_params(named, "unet."), model.unet_config)
    if upstream_4ch:
        unet["input_blocks.0.0.weight"] = unet["input_blocks.0.0.weight"][:, :4]
    for prefix, part in (("model.diffusion_model.", unet),
                         ("first_stage_model.",
                          kl_vae_reference_sd(sub_params(named, "vae."), model.vae_config)),
                         ("cond_stage_model.model.visual.",
                          clip_reference_sd(sub_params(named, "clip."),
                                            model.clip_config.layers))):
        sd.update({prefix + k: v for k, v in part.items()})
    sd["cc_projection.weight"], sd["cc_projection.bias"] = named["cc.weight"], named["cc.bias"]
    return sd


def video_vae_reference_sd(p, cfg):
    """CogVideoX ContextParallel{En,De}coder3D keys (``port_video_vae``'s
    input) of a port ``VideoVAE``'s parameters."""
    sd = {}

    def cconv(tp, fp):
        sd[tp + ".conv.weight"], sd[tp + ".conv.bias"] = p[fp + ".conv.weight"], p[fp + ".conv.bias"]

    def conv2d(tp, fp):
        sd[tp + ".weight"], sd[tp + ".bias"] = p[fp + ".conv.weight"], p[fp + ".conv.bias"]

    def norm(tp, fp, zq):
        w = ".norm_layer" if zq else ""
        sd[tp + w + ".weight"], sd[tp + w + ".bias"] = p[fp + ".scale"], p[fp + ".bias"]
        if zq:
            cconv(tp + ".conv_y", fp + ".conv_y")
            cconv(tp + ".conv_b", fp + ".conv_b")

    def res(tp, fp, zq):
        norm(tp + ".norm1", fp + ".norm1", zq)
        cconv(tp + ".conv1", fp + ".conv1")
        norm(tp + ".norm2", fp + ".norm2", zq)
        cconv(tp + ".conv2", fp + ".conv2")
        if fp + ".nin_shortcut.weight" in p:
            sd[tp + ".nin_shortcut.weight"] = p[fp + ".nin_shortcut.weight"][:, :, None, None, None]
            sd[tp + ".nin_shortcut.bias"] = p[fp + ".nin_shortcut.bias"]

    n = len(cfg.ch_mult)
    for side, zq, blocks in (("encoder", False, cfg.num_res_blocks),
                             ("decoder", True, cfg.num_res_blocks + 1)):
        cconv(f"{side}.conv_in", f"{side}.conv_in")
        res(f"{side}.mid.block_1", f"{side}.mid_block_1", zq)
        res(f"{side}.mid.block_2", f"{side}.mid_block_2", zq)
        norm(f"{side}.norm_out", f"{side}.norm_out", zq)
        cconv(f"{side}.conv_out", f"{side}.conv_out")
        way, sample = ("down", "downsample") if side == "encoder" else ("up", "upsample")
        for i in range(n):
            for j in range(blocks):
                res(f"{side}.{way}.{i}.block.{j}", f"{side}.{way}_{i}_block_{j}", zq)
            if (side == "encoder" and i != n - 1) or (side == "decoder" and i != 0):
                conv2d(f"{side}.{way}.{i}.{sample}.conv", f"{side}.{way}_{i}_{sample}")
    return sd


def sat_dit_state_dict(cfg, generator, lora_rank=0, dtype=torch.float32):
    """A SAT ``DiffusionTransformer`` state dict at ``cfg`` (the keys and
    shapes ``port_video_dit`` reads), drawn from ``generator`` on its device:
    weights normal / sqrt(fan-in), biases 0.02 normal, LayerNorm weights 1 +
    0.05 normal. With ``lora_rank`` the attention linears are in the raw
    SAT-lora2 layout (``.original.weight``, ``matrix_A.{p}`` (r, in) and
    ``matrix_B.{p}`` (out / P, r); 3 partitions for ``query_key_value``, 1
    for ``dense``), as a finetune of cogvideox_5b_lora_prefixi2v.yaml saves
    them."""
    d, hd, t = cfg.hidden_size, cfg.head_dim, cfg.temb_dim
    p, ci, co = cfg.patch_size, cfg.in_channels, cfg.out_channels
    dev = generator.device

    def w(*shape):
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        return (torch.randn(shape, generator=generator, device=dev) / float(np.sqrt(fan))
                if len(shape) > 1 else 0.02 * torch.randn(shape, generator=generator,
                                                         device=dev)).to(dtype)

    def ln(key, n):
        sd[key + ".weight"] = (1 + 0.05 * torch.randn(n, generator=generator,
                                                       device=dev)).to(dtype)
        sd[key + ".bias"] = w(n)

    def lin(key, n_out, n_in, parts=0):
        if lora_rank and parts:
            sd[key + ".original.weight"], sd[key + ".original.bias"] = w(n_out, n_in), w(n_out)
            for i in range(parts):
                sd[f"{key}.matrix_A.{i}"] = w(lora_rank, n_in)
                sd[f"{key}.matrix_B.{i}"] = w(n_out // parts, lora_rank)
        else:
            sd[key + ".weight"], sd[key + ".bias"] = w(n_out, n_in), w(n_out)

    sd = {"mixins.patch_embed.proj.weight": w(d, ci, p, p),
          "mixins.patch_embed.proj.bias": w(d)}
    lin("mixins.patch_embed.text_proj", d, cfg.text_hidden_size)
    lin("time_embed.0", t, d)
    lin("time_embed.2", t, t)
    ln("transformer.final_layernorm", d)
    ln("mixins.final_layer.norm_final", d)
    lin("mixins.final_layer.adaLN_modulation.1", 2 * d, t)
    lin("mixins.final_layer.linear", p * p * co, d)
    for i in range(cfg.num_layers):
        tl, a = f"transformer.layers.{i}", "mixins.adaln_layer"
        lin(f"{a}.adaLN_modulations.{i}.1", 12 * d, t)
        ln(f"{a}.query_layernorm_list.{i}", hd)
        ln(f"{a}.key_layernorm_list.{i}", hd)
        ln(f"{tl}.input_layernorm", d)
        ln(f"{tl}.post_attention_layernorm", d)
        lin(f"{tl}.attention.query_key_value", 3 * d, d, parts=3)
        lin(f"{tl}.attention.dense", d, d, parts=1)
        lin(f"{tl}.mlp.dense_h_to_4h", cfg.mlp_ratio * d, d)
        lin(f"{tl}.mlp.dense_4h_to_h", d, cfg.mlp_ratio * d)
    return sd
