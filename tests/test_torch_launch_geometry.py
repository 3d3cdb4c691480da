"""The Python around the two redesigned kernels, on the CPU.

* ``bfs_relax``: the cluster size from O (at most one CTA per SM, any
  count up to 8, the largest whose clusters the card holds at once), the
  word-aligned node slices of a cluster's CTAs, the frontier words a pass
  compacts and the list they fill, and the state per CTA at the main
  shapes: in shared memory after the list where it fits, else in a
  device-memory scratch buffer (so any N is taken);
* ``rc_merge_prune``: the shared-memory bytes of a row, the rows per block,
  and the row-width limit (raised in bytes, beyond one block's shared
  memory);
* ``rank_inbound``: the CTAs of an origin (the most whose clusters the
  card holds in one wave), each CTA's target slice, the warps of the
  selection and their buffers, the counts and segment starts per CTA (in
  shared memory where they fit, else in a device-memory scratch buffer, so
  any N and any K the engine takes run) and the room for CSR keys;
* the precondition of the ``rc_merge_prune`` kernel: every received-cache
  row the engine carries holds its members sorted ascending and unique,
  then N;
* ``push_targets`` and ``rotate`` (a thread per row, the block's rows
  staged in shared memory): 128 rows per block, fewer for wide rows, down
  to one, and a raise, in bytes, past one block's shared memory;
  ``rotate``'s keys, T + 2 of each origin a block spans, and
  ``push_targets``' one-wave grid of tiles;
* ``pull_exchange``: the cluster of an origin (one wave at O = 1, 3, 64
  and 200), each CTA's node slice, and the bytes of its shared memory
  (bitmaps, per-peer words, kept draws): the draws kept, a larger cluster
  where they do not fit, drawn again as the last resort, and past every
  cluster's shared memory the per-peer words in device memory;
* ``health_round``: the round form's cluster per row (its CTAs, the
  nodes each owns, where it counts: a whole plane, its own nodes, past
  both device memory), the traffic form's cooperative launch of one wave of blocks
  at most, and the per-lane records a call packs; ``health_digest``: its tiles of 1,024 entries, its grid (a block
  per tile or per 8 scan warps, at most one wave) and its scratch regions,
  at the sim and traffic widths, N = 1, 1,025 and 100,000.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import importlib

import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import rng
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams

bfs = importlib.import_module("gossip_sim_tpu_torch.kernels.bfs_relax")
mp = importlib.import_module("gossip_sim_tpu_torch.kernels.rc_merge_prune")
ri = importlib.import_module("gossip_sim_tpu_torch.kernels.rank_inbound")
pt = importlib.import_module("gossip_sim_tpu_torch.kernels.push_targets")
rot = importlib.import_module("gossip_sim_tpu_torch.kernels.rotate")
px = importlib.import_module("gossip_sim_tpu_torch.kernels.pull_exchange")

# an H100 SXM: streaming multiprocessors, opt-in shared memory per block
SMS, SMEM_PER_BLOCK = 132, 232_448


@pytest.mark.parametrize("o,cs", [(1, 8), (3, 8), (16, 8), (17, 7),
                                  (18, 7), (19, 6), (32, 4), (33, 4),
                                  (34, 3), (41, 3), (44, 3), (45, 2),
                                  (66, 2), (67, 1), (200, 1), (10_000, 1)])
def test_bfs_cluster_takes_one_sm_per_cta(o, cs):
    """The most CTAs per origin, up to 8, at most one per SM of the 132:
    any count, so O = 41 (the auto batch at N = 100,000) takes 3 x 41 =
    123 SMs where powers of two left 50 empty."""
    g = bfs.launch_geometry(o, 10_000, SMS, SMEM_PER_BLOCK)
    assert g.cs == cs
    assert o * cs <= SMS or cs == 1
    assert cs == bfs.MAX_CLUSTER or o * (cs + 1) > SMS


def test_bfs_cluster_fills_the_card_in_one_wave():
    """A cluster size whose clusters the card does not hold at once (read
    from the device) gives way to the next smaller one: a card that holds
    30 clusters of 4 takes O = 32 in clusters of 3."""
    held = {8: 15, 7: 16, 6: 20, 5: 24, 4: 30, 3: 40, 2: 64}
    pick = lambda o: bfs.launch_geometry(o, 10_000, SMS, SMEM_PER_BLOCK,
                                         lambda g: held[g.cs]).cs
    assert [pick(o) for o in (1, 8, 15, 16, 20, 30, 32, 41, 44, 64, 65,
                              200)] == [8, 8, 8, 7, 6, 4, 3, 2, 2, 2, 1, 1]
    seen = []
    bfs.launch_geometry(41, 100_000, SMS, SMEM_PER_BLOCK,
                        lambda g: seen.append(g) or 0)
    assert [g.cs for g in seen] == [3, 2]        # asked largest first
    assert seen[0] == bfs.shape(41, 100_000, 3, SMEM_PER_BLOCK)


@pytest.mark.parametrize("n", [1, 31, 40, 1000, 1001, 10_000, 32_767, 65_535,
                               65_536, 1_000_003])
@pytest.mark.parametrize("cs", [1, 2, 3, 8])
def test_slices_tile_the_nodes_word_aligned(n, cs):
    bounds = bfs.slice_bounds(n, cs)
    s = bfs.slice_len(n, cs)
    assert len(bounds) == cs and s % 32 == 0 and s * cs >= n
    assert s - 32 < -(-n // cs)                 # no more than one word over
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
    for r, (lo, hi) in enumerate(bounds):
        assert 0 <= hi - lo <= s
        assert lo == n or lo == r * s           # each slice starts a word


@pytest.mark.parametrize("n,cs,chunk", [
    (1, 1, 32), (40, 8, 32), (1000, 1, 32), (1025, 1, 64), (10_000, 8, 64),
    (10_000, 4, 96), (10_000, 2, 160), (10_000, 1, 320),
    (100_000, 3, 512), (1_000_000, 8, 512)])
def test_bfs_chunk_is_the_slice_up_to_512_words(n, cs, chunk):
    """A pass compacts the slice's frontier words (whole warps of them, up
    to 512), and the list holds 32 nodes a word: one pass always fits."""
    assert bfs.chunk_words(n, cs) == chunk
    assert chunk % 32 == 0 and chunk <= bfs.MAX_CHUNK <= bfs.THREADS
    words = bfs.slice_len(n, cs) // 32
    assert chunk >= min(words, bfs.MAX_CHUNK)
    assert bfs.list_bytes(n, cs) == 4 * (32 * chunk + bfs.TOT_WORDS)


# the main shapes: (O, N) -> (cs, slice, chunk, state words, smem, scratch,
# the bytes the list and the state use); a cluster's CTA asks for 116,225
# bytes (more than half an SM's) so that it has an SM to itself
ONE_PER_SM = SMEM_PER_BLOCK // 2 + 1
BFS_MAIN = {
    "O=1 N=10,000": ((1, 10_000), (8, 1280, 64, 722, ONE_PER_SM, 0), 11_208),
    "O=32 N=10,000": ((32, 10_000), (4, 2528, 96, 792, ONE_PER_SM, 0),
                      15_584),
    "O=64 N=10,000": ((64, 10_000), (2, 5024, 160, 944, ONE_PER_SM, 0),
                      24_384),
    "O=41 N=100,000": ((41, 100_000), (3, 33_344, 512, 8338, ONE_PER_SM, 0),
                       99_016),
    "8 lanes x O=1 N=10,000": ((8, 10_000),
                               (8, 1280, 64, 722, ONE_PER_SM, 0), 11_208),
    "O=200 N=10,000": ((200, 10_000), (1, 10_016, 320, 1254, 46_104, 0),
                       46_104),
    "O=1 N=1,000,000 (device memory)": (
        (1, 1_000_000), (8, 125_024, 512, 70_328, ONE_PER_SM, 562_624),
        65_664),
    "O=41 N=600,000 (device memory)": (
        (41, 600_000), (3, 200_000, 512, 50_002, ONE_PER_SM, 6_150_246),
        65_664),
}


@pytest.mark.parametrize("case", list(BFS_MAIN))
def test_bfs_geometry_of_the_main_shapes(case):
    """The list (32 x chunk words and 32 warp totals) then the state:
    reached and frontier bitmaps of the slice, two sent bitmaps of all cs
    slices, two flag words; past the shared memory the state goes to
    device memory and the list stays.  A cluster's CTA asks for more than
    half of an SM's shared memory, one CTA per origin for what it uses."""
    (o, n), want, used = BFS_MAIN[case]
    g = bfs.launch_geometry(o, n, SMS, SMEM_PER_BLOCK)
    assert tuple(g) == want
    words = g.slice_len // 32
    assert g.state_words == (2 + 2 * g.cs) * words + 2
    in_smem = g.scratch_words == 0
    assert used == bfs.list_bytes(n, g.cs) + (4 * g.state_words
                                              if in_smem else 0)
    assert g.smem == bfs.one_per_sm(used, g.cs, SMEM_PER_BLOCK)
    assert used <= g.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("used", [0, 11_208, 99_016, 116_225, 180_000])
@pytest.mark.parametrize("cs", [1, 2, 8])
def test_bfs_cluster_ctas_take_an_sm_each(cs, used):
    """Two CTAs that ask for one_per_sm's bytes do not fit one SM of the
    H100 (228 KB of shared memory, 1 KB reserved per block); a lone CTA per
    origin asks for what it uses."""
    smem = bfs.one_per_sm(used, cs, SMEM_PER_BLOCK)
    assert used <= smem <= max(used, SMEM_PER_BLOCK)
    if cs > 1:
        assert 2 * (smem + 1024) > 228 * 1024
    else:
        assert smem == used


def test_bfs_geometry_takes_every_node_count_to_its_limit():
    """State that fits a block's shared memory beside the list stays
    there; beyond it, the state of every CTA goes to one device-memory
    scratch buffer, so the kernel takes any N the engine does."""
    for o in (1, 32, 41, 67, 200):
        _check_node_counts(o)


def _check_node_counts(o):
    cs = bfs.launch_geometry(o, 10_000, SMS, SMEM_PER_BLOCK).cs
    fits = max(n for n in range(32, 1 << 21, 32)
               if bfs.list_bytes(n, cs) + 4 * bfs.state_words(n, cs)
               <= SMEM_PER_BLOCK)
    assert fits > 300_000                         # far past 16-bit hops
    pad = lambda used: bfs.one_per_sm(used, cs, SMEM_PER_BLOCK)
    g = bfs.launch_geometry(o, fits, SMS, SMEM_PER_BLOCK)
    assert g.cs == cs and g.scratch_words == 0
    assert g.smem == pad(bfs.list_bytes(fits, cs) + 4 * g.state_words)
    for n in (fits + 1, 5_000_000, 1 << 24):
        g = bfs.launch_geometry(o, n, SMS, SMEM_PER_BLOCK)
        assert g.cs == cs and g.smem == pad(bfs.list_bytes(n, cs))
        assert g.scratch_words == o * cs * bfs.state_words(n, cs)
    # a smaller shared memory moves the same shape's state to scratch
    g = bfs.launch_geometry(o, 10_000, SMS, 0)
    assert g.scratch_words > 0 and g.smem == bfs.list_bytes(10_000, g.cs)


@pytest.mark.parametrize("o,n", [(1, 10_000), (64, 10_000), (41, 100_000)])
def test_bfs_geometry_is_read_once_per_shape(monkeypatch, o, n):
    """``geometry_for`` asks the device (SMs, shared memory, one-wave
    cluster counts) once per (O, N, device), not at every launch: the push
    round is host-bound and calls it every round."""
    asked = []
    monkeypatch.setattr(bfs, "_GEOMETRY", {})
    monkeypatch.setattr(bfs._build, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(bfs._build, "smem_optin", lambda dev: SMEM_PER_BLOCK)
    monkeypatch.setattr(bfs, "max_clusters",
                        lambda g: asked.append(g.cs) or 132 // g.cs)
    dev = torch.device("cuda", 0)
    g = bfs.geometry_for(o, n, dev)
    first = len(asked)
    assert first >= 1
    assert g == bfs.launch_geometry(o, n, SMS, SMEM_PER_BLOCK,
                                    lambda g_: 132 // g_.cs)
    for _ in range(3):
        assert bfs.geometry_for(o, n, dev) is g
    assert len(asked) == first
    bfs.geometry_for(o, n + 32, dev)             # another shape is read
    assert len(asked) > first


def test_bfs_geometry_refuses_empty_shapes():
    for o, n in ((0, 10), (1, 0)):
        with pytest.raises(ValueError, match="needs O, N"):
            bfs.shape(o, n, 1, SMEM_PER_BLOCK)


@pytest.mark.parametrize("c,k,row,sparse_row", [
    (1, 1, 48, 48), (3, 1, 128, 112), (16, 4, 560, 432),
    (64, 16, 2240, 1728), (128, 16, 4288, 3264), (256, 64, 8960, 6912)])
def test_merge_row_shared_memory(c, k, row, sparse_row):
    """The sparse variant stages two member planes (src, score), not four."""
    p = 1 << (c - 1).bit_length()
    assert mp.row_smem_bytes(c, k) == row == -(-(16 * p + 16 * c + 12 * k)
                                              // 16) * 16
    assert mp.row_smem_bytes(c, k, True) == sparse_row == -(
        -(16 * p + 8 * c + 12 * k) // 16) * 16
    g = mp.launch_geometry(c, k, SMEM_PER_BLOCK)
    assert g == (mp.ROWS_PER_BLOCK, p, row, mp.ROWS_PER_BLOCK * row)
    g = mp.launch_geometry(c, k, SMEM_PER_BLOCK, sparse=True)
    assert g == (mp.ROWS_PER_BLOCK, p, sparse_row,
                 mp.ROWS_PER_BLOCK * sparse_row)


def test_merge_row_width_limit_is_shared_memory():
    # the old fixed limit of 128 entries per row is gone: rc_slots = 128
    # with the default k_inbound of 16, and 256 with 64, are taken
    geo = mp.launch_geometry
    assert geo(128, 16, SMEM_PER_BLOCK).rows_per_block == mp.ROWS_PER_BLOCK
    assert geo(256, 64, SMEM_PER_BLOCK).rows_per_block == mp.ROWS_PER_BLOCK
    # wide rows take fewer rows per block, down to one
    g = geo(4096, 64, SMEM_PER_BLOCK)
    assert 1 <= g.rows_per_block < mp.ROWS_PER_BLOCK
    assert g.smem == g.rows_per_block * g.row_bytes <= SMEM_PER_BLOCK
    widest = max(c for c in range(1, 8192)
                 if mp.row_smem_bytes(c, 64) <= SMEM_PER_BLOCK)
    row = mp.row_smem_bytes(widest, 64)
    assert geo(widest, 64, SMEM_PER_BLOCK) == (1, mp.key_slots(widest), row,
                                               row)
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        geo(widest + 1, 64, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="k_inbound >= 1"):
        geo(64, 0, SMEM_PER_BLOCK)


@pytest.mark.parametrize("kw", [
    dict(warm_up_rounds=0, received_cap=2, rc_slots=16,
         probability_of_rotation=1.0),
    dict(warm_up_rounds=0, rc_slots=128),
    dict(warm_up_rounds=0, representation="sparse"),
], ids=["overflowing", "rc_slots_128", "sparse"])
def test_engine_keeps_the_merge_kernels_precondition(kw):
    n = 120
    stakes = np.random.default_rng(2).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    origins = torch.tensor([0, 5, 77], dtype=torch.int32)
    params = EngineParams(num_nodes=n, **kw)
    state = tc.init_state(rng.prng_key(9), tables, origins, params)
    live_rows = 0
    for it in range(24):
        state, _ = tc.round_step(params, tables, origins, state, it)
        src = state.rc_src
        member = src < n
        # members first, then N; strictly ascending (so unique)
        assert bool((member[..., 1:] <= member[..., :-1]).all())
        both = member[..., 1:] & member[..., :-1]
        assert bool((src[..., 1:] > src[..., :-1])[both].all())
        assert bool((src[~member] == n).all())
        live_rows += int(member.any(-1).sum())
    assert live_rows > 0


def _check_rank_geometry(o, n, k, g):
    words = ri.warp_buffer_words(k)
    sel = 4 * (ri.MISC_WORDS + g.threads // 32 * words)
    assert g.cs == max(1, min(ri.MAX_CLUSTER, SMS // o))
    assert g.slice_len == -(-n // g.cs)            # ranks past N own nothing
    assert g.threads == 32 * ri.MAX_WARPS           # K <= 256: all warps
    assert g.state_words == 2 * g.slice_len
    if g.scratch_words == 0:
        used = sel + 4 * g.state_words
    else:
        used = sel
        assert sel + 4 * g.state_words > SMEM_PER_BLOCK
        assert g.scratch_words == o * g.cs * g.state_words
    # the CSR keys of the slice take the rest of the shared memory
    assert g.csr_cap == (SMEM_PER_BLOCK - used) // 4
    assert SMEM_PER_BLOCK - 4 < g.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("k", [1, 4, 16, 64, 128, 256])
@pytest.mark.parametrize("o", [1, 32, 67, 200])
def test_rank_geometry_takes_every_node_count(o, k):
    """Every N up to the engine's 2^24 launches: the counts and segment
    starts of a CTA's slice sit in shared memory up to a limit, past it in
    device memory; the selection buffers always fit."""
    cs = max(1, min(ri.MAX_CLUSTER, SMS // o))
    sel = 4 * (ri.MISC_WORDS + ri.MAX_WARPS * ri.warp_buffer_words(k))
    fits = cs * ((SMEM_PER_BLOCK - sel) // 8)        # largest N in smem
    assert fits > 19_000
    for n in sorted({1, 2, 31, 1000, 10_000, fits - 1, fits, fits + 1,
                     1_000_003, 1 << 24}):
        g = ri.launch_geometry(o, n, k, SMS, SMEM_PER_BLOCK)
        _check_rank_geometry(o, n, k, g)
        assert (g.scratch_words == 0) == (n <= fits), n


def test_rank_geometry_fills_the_card_in_one_wave():
    """The most CTAs per origin (at most one per SM) whose clusters the
    card holds at once: a card that holds 30 clusters of 4 takes O = 32 in
    clusters of 3."""
    held = {8: 15, 7: 16, 6: 20, 5: 24, 4: 30, 3: 40, 2: 64}
    pick = lambda o: ri.launch_geometry(o, 10_000, 16, SMS, SMEM_PER_BLOCK,
                                        lambda g: held[g.cs]).cs
    assert [pick(o) for o in (1, 15, 16, 20, 30, 32, 44, 64, 65, 200)] == [
        8, 8, 7, 6, 4, 3, 2, 2, 1, 1]
    g = ri.launch_geometry(32, 10_000, 16, SMS, SMEM_PER_BLOCK,
                           lambda g: held[g.cs])
    assert g == ri.shape(32, 10_000, 16, 3, SMEM_PER_BLOCK)


def test_rank_geometry_k_limit_is_shared_memory():
    """No fixed K limit: wide rankings take fewer warps per CTA, down to
    one, and the wrapper raises, naming the bytes, only where one warp's
    buffers exceed a block's shared memory, a K far past what the
    rc_merge_prune row of the engine (rc_slots >= 1) can take."""
    g = ri.launch_geometry(1, 10_000, 4096, SMS, SMEM_PER_BLOCK)
    assert 1 <= g.threads // 32 < ri.MAX_WARPS
    kmax = ri.max_k_inbound(SMEM_PER_BLOCK)
    assert kmax > max(k for k in range(1, 40_000)
                      if mp.row_smem_bytes(1, k) <= SMEM_PER_BLOCK)
    g = ri.launch_geometry(1, 10_000, kmax, SMS, SMEM_PER_BLOCK)
    assert g.threads == 32 and g.smem <= SMEM_PER_BLOCK
    assert g.scratch_words > 0 and g.csr_cap == 0
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        ri.launch_geometry(1, 10_000, kmax + 1, SMS, SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="k_inbound >= 1"):
        ri.launch_geometry(1, 10_000, 0, SMS, SMEM_PER_BLOCK)


@pytest.mark.parametrize("o,n,k,want", [
    (32, 10_000, 16, (4, 2500, 1024, 5000, 49_976, 232_448, 0)),
    (1, 10_000, 16, (8, 1250, 1024, 2500, 52_476, 232_448, 0)),
    (32, 10_000, 128, (4, 2500, 1024, 5000, 42_808, 232_448, 0)),
    (1, 300_000, 16, (8, 37_500, 1024, 75_000, 54_976, 232_448, 600_000)),
])
def test_rank_geometry_of_the_main_shapes(o, n, k, want):
    assert tuple(ri.launch_geometry(o, n, k, SMS, SMEM_PER_BLOCK)) == want


@pytest.mark.parametrize("s,f", [(12, 6), (25, 6), (1, 1), (64, 64)])
def test_row_kernels_stage_128_rows_of_the_engine_widths(s, f):
    # push_targets: the targets, then two buffers of the slot planes
    assert pt.launch_geometry(s, f, SMEM_PER_BLOCK) == (128, 128 * (12 * s
                                                                    + 6 * f))
    # rotate: the round key and the sub keys of two origins (N = 10,000,
    # T = 8), then the rows
    g = rot.launch_geometry(s, 8, 10_000, 32, SMEM_PER_BLOCK)
    assert g == (128, 2 * 10 * 8, 2 * 10 * 8 + 128 * 6 * s)


@pytest.mark.parametrize("kernel", ["push_targets", "rotate"])
def test_row_kernels_take_wide_rows_down_to_one_per_block(kernel):
    if kernel == "push_targets":
        # 36 bytes of targets and two buffers of 6 S bytes, each part
        # 16-byte padded
        geo = lambda s: pt.launch_geometry(s, 6, SMEM_PER_BLOCK)
        room = SMEM_PER_BLOCK
        one = lambda s: 48 + 2 * (-(-6 * s // 16) * 16)
    else:
        # the staged rows after the keys of one origin (T = 8: the round
        # key and 9 sub keys of 8 bytes), or of two beside more rows
        geo = lambda s: tuple(rot.launch_geometry(s, 8, 10_000, 32,
                                                  SMEM_PER_BLOCK))[::2]
        room = SMEM_PER_BLOCK - rot.TABLE_BYTES
        one = lambda s: 6 * s + 80
    assert rot.TABLE_BYTES == 2704     # 2,700 B of tables, 16-byte padded
    rows, smem = geo(1000)
    assert 1 < rows < 128
    assert smem <= room < smem + one(1000)
    widest = max(s for s in range(room // 24, room // 6 + 1)
                 if one(s) <= room)
    assert geo(widest) == (1, one(widest))
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        geo(widest + 1)


@pytest.mark.parametrize("n", [1, 16, 127, 128, 10_000])
@pytest.mark.parametrize("o", [1, 3, 32, 200])
def test_rotate_key_buffer_holds_every_origin_a_block_spans(n, o):
    """The keys a block derives: the round key and T + 1 sub keys of each
    origin its rows span.  ``key_origins`` is the most origins any block of the launch
    spans (counted block by block), and equal to it where the rows reach
    that many."""
    t = 8
    g = rot.launch_geometry(12, t, n, o, SMEM_PER_BLOCK)
    rows = o * n
    spans = [(min(r0 + g.rows, rows) - 1) // n - r0 // n + 1
             for r0 in range(0, rows, g.rows)]
    k = rot.key_origins(g.rows, n, o)
    assert max(spans) <= k
    # with origins enough, some block spans that many: over one period of
    # the blocks' starting offsets within an origin
    worst = max((b * g.rows % n + g.rows - 1) // n + 1 for b in range(n))
    assert k == min(o, worst)
    assert g.key_bytes == -(-k * (t + 2) * 8 // 16) * 16
    assert g.smem == g.key_bytes + g.rows * 6 * 12
    want = {1: 128, 16: 8, 127: 2, 128: 1, 10_000: 2}[n]
    assert k == min(o, want)


def test_rotate_key_buffer_shrinks_the_block_before_it_refuses():
    """Many tries at N = 1 (a block spans one origin per row): fewer rows
    per block, down to one row and its origin's keys; past that a raise
    that names the bytes."""
    room = SMEM_PER_BLOCK - rot.TABLE_BYTES
    g = rot.launch_geometry(12, 1000, 1, 512, SMEM_PER_BLOCK)
    assert g.rows == room // (1002 * 8 + 72) < 128
    assert g.smem <= room < g.smem + 1002 * 8 + 72
    tries = room // 8 - 2 - 10
    assert rot.launch_geometry(12, tries, 1, 512, SMEM_PER_BLOCK).rows == 1
    with pytest.raises(ValueError, match=r"sub keys \d+ bytes, more than"):
        rot.launch_geometry(12, room // 8, 1, 512, SMEM_PER_BLOCK)


@pytest.mark.parametrize("o,n,per_sm,want", [
    (32, 10_000, 9, (2500, 1188)),      # the main shape: one wave of 1,188
    (1, 10_000, 9, (79, 79)),           # fewer tiles than the wave
    (32, 100_000, 9, (25_000, 1188)),   # some 21 tiles per block
    (3, 10_001, 16, (235, 235)),
    (1, 1, 9, (1, 1)),
])
def test_push_targets_runs_one_wave_of_tiles(o, n, per_sm, want):
    rows, _ = pt.launch_geometry(12, 6, SMEM_PER_BLOCK)
    tiles, grid = pt.persistent_grid(o * n, rows, SMS, per_sm)
    assert (tiles, grid) == want
    assert tiles * rows >= o * n > (tiles - 1) * rows
    assert grid == min(tiles, SMS * per_sm)
    # the blocks walk the tiles with a grid stride: each tile once
    walked = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert walked == list(range(tiles))


def _largest_smem_n(fanout, cap):
    """The largest N whose pull_exchange launch keeps its state in shared
    memory at the largest cluster (the draws drawn again where used)."""
    lo, hi = 1, 1 << 30
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if px.shape(1, mid, fanout, cap, px.MAX_CLUSTER,
                    keep=False).smem <= SMEM_PER_BLOCK:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _check_pull_geometry(o, n, fanout, cap, g):
    assert 1 <= g.cs <= px.MAX_CLUSTER and g.cs & (g.cs - 1) == 0
    assert g.slice_len == -(-n // g.cs) and g.slice_len * g.cs >= n
    assert g.threads % 32 == 0 and 32 <= g.threads <= px.MAX_THREADS
    assert g.threads >= min(g.slice_len, px.MAX_THREADS)
    per_peer = 4 if cap > 0 else 2
    if g.scratch_words:
        assert g.bitmap_words == g.state_words == g.draw_words == 0
        assert g.scratch_words == o * per_peer * n
    else:
        assert g.bitmap_words == 3 * -(-n // 32)
        assert g.state_words == (per_peer + 1) * g.slice_len
        assert g.draw_words in (0, fanout * g.slice_len)
        assert g.draw_words == 0 or cap > 0
    assert g.smem == 4 * (px.MISC_WORDS + g.bitmap_words + g.state_words
                          + g.draw_words) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("cap", [0, 2])
def test_pull_geometry_fills_the_card_in_one_wave(cap):
    """The largest power-of-two cluster (up to the non-portable 16) whose
    O clusters fill the 132 SMs in one wave: 16 CTAs at O = 1 and 3, 2 at
    O = 64, 1 at O = 200 with the cap off; a card that holds 7 clusters
    of 16 takes O = 8 in clusters of 8.  With the cap on at O = 200 the
    kept draws do not fit one CTA (284,268 bytes), so the cluster grows
    to 2."""
    want = {1: 16, 3: 16, 8: 16, 64: 2, 200: 1 if cap == 0 else 2}
    for o, cs in want.items():
        g = px.launch_geometry(o, 10_000, 2, cap, SMS, SMEM_PER_BLOCK)
        _check_pull_geometry(o, 10_000, 2, cap, g)
        assert g.cs == cs == px.cluster_size(o, SMS) or (o, cap) == (200, 2)
        assert o * g.cs <= SMS or g.cs <= 2
        assert g.cs == px.MAX_CLUSTER or o * g.cs * 2 > SMS or o == 200
        assert g.draw_words == (2 * g.slice_len if cap else 0)
    assert px.shape(200, 10_000, 2, 2, 1).smem == 284_268 > SMEM_PER_BLOCK
    held = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}
    pick = lambda o: px.launch_geometry(o, 10_000, 2, cap, SMS,
                                        SMEM_PER_BLOCK,
                                        lambda g: held[g.cs]).cs
    one = 1 if cap == 0 else 2          # the kept draws need two CTAs
    assert [pick(o) for o in (1, 3, 7, 8, 16, 33, 34, 64, 67, 200)] == [
        16, 16, 16, 8, 8, 4, 2, 2, one, one]
    # a card without clusters of 16 takes 8 at O = 1
    no16 = lambda g: 0 if g.cs == 16 else 99
    assert px.launch_geometry(1, 10_000, 2, cap, SMS, SMEM_PER_BLOCK,
                              no16).cs == 8


@pytest.mark.parametrize("o,cap,want", [
    # cs, slice, threads, bitmap, node and draw words, smem, scratch
    (1, 0, (16, 625, 640, 939, 1875, 0, 11_768, 0)),
    (1, 2, (16, 625, 640, 939, 3125, 1250, 21_768, 0)),
    (32, 0, (4, 2500, 1024, 939, 7500, 0, 34_268, 0)),
    (64, 0, (2, 5000, 1024, 939, 15_000, 0, 64_268, 0)),
    (64, 2, (2, 5000, 1024, 939, 25_000, 10_000, 144_268, 0)),
    (200, 0, (1, 10_000, 1024, 939, 30_000, 0, 124_268, 0)),
    (200, 2, (2, 5000, 1024, 939, 25_000, 10_000, 144_268, 0)),
])
def test_pull_geometry_shared_memory_at_n_10000(o, cap, want):
    """Per CTA at N = 10,000, pull fanout 2: 512 bytes of class tables and
    sums, three bitmaps of 313 words, 12 bytes a node of the slice (20
    with the cap on: requests in, responses out, the node's own counts,
    the cap's two keys) and, with the cap on, the kept draws (4 bytes a
    live slot)."""
    g = px.launch_geometry(o, 10_000, 2, cap, SMS, SMEM_PER_BLOCK)
    _check_pull_geometry(o, 10_000, 2, cap, g)
    assert tuple(g) == want


@pytest.mark.parametrize("fanout,cap,largest", [(2, 0, 206_160),
                                                (2, 2, 142_720),
                                                (8, 5, 142_720)])
def test_pull_geometry_takes_every_node_count(fanout, cap, largest):
    """The largest N whose state a cluster of 16 keeps in shared memory
    (the draws drawn again where used; with the cap on the draws are kept
    up to a smaller N), and past it the per-peer words in device memory;
    every N runs."""
    assert _largest_smem_n(fanout, cap) == largest
    kept = max(n for n in range(1000, largest + 1, 1000)
               if px.shape(1, n, fanout, cap, 16).smem <= SMEM_PER_BLOCK)
    for n in sorted({1, 7, 121, 10_000, 10_007, kept, kept + 1000,
                     largest - 1, largest, largest + 1, 1_000_003,
                     (1 << 24) - 1}):
        g = px.launch_geometry(1, n, fanout, cap, SMS, SMEM_PER_BLOCK)
        _check_pull_geometry(1, n, fanout, cap, g)
        assert (g.scratch_words == 0) == (n <= largest), n
        if cap > 0 and not g.scratch_words:
            assert (g.draw_words > 0) == (n <= kept), n
    g = px.launch_geometry(1, largest, fanout, cap, SMS, SMEM_PER_BLOCK)
    assert g.cs == 16 and g.smem <= SMEM_PER_BLOCK < px.shape(
        1, largest + 1, fanout, cap, 16, keep=False).smem
    g = px.launch_geometry(64, largest + 1, fanout, cap, SMS,
                           SMEM_PER_BLOCK)
    assert g.cs == 2 and g.smem == 512
    assert g.scratch_words == 64 * (4 if cap > 0 else 2) * (largest + 1)


def test_pull_geometry_raises_past_the_class_tables():
    """A block without room for the class tables and sums (512 bytes)
    takes no launch; the error names the bytes."""
    g = px.launch_geometry(3, 10_000, 2, 2, SMS, 512)
    assert g.scratch_words > 0 and g.smem == 512
    with pytest.raises(ValueError, match=r"needs 512 bytes of shared memory"):
        px.launch_geometry(3, 10_000, 2, 2, SMS, 511)


hr_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.health_round")
hd_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.health_digest")


SMEM = 232_448                    # the H100's opt-in shared memory a block

#: (R rows, N, (cs, chunk, shared bytes, mode, threads)): a cluster of cs
#: CTAs a row, about two CTAs and 512 threads an SM over the rows, at most
#: 8 CTAs and 8,192 threads: O=32 of N=10,000 (the portable 8 of 256
#: threads, a whole plane each, a multiple of 4 nodes each), O=1 (8 of
#: 1,024), 8 lanes x 4 origins, O=64 (4), O=200 (one CTA a row), N=45 (6
#: CTAs of 8), N=1; N=58,108, the most whose counts and 16-byte busy flag
#: fill the opt-in shared memory exactly, and N=58,112 past it; past a
#: plane the counts in device memory: O=41 of N=100,000 (6 CTAs of
#: 16,667 nodes), N=500,000 and 1,000,000
ROUND_GEOMETRY = [
    (32, 10_000, (8, 1_252, 40_016, hr_mod.PLANE, 256)),
    (1, 10_000, (8, 1_252, 40_016, hr_mod.PLANE, 1_024)),
    (8 * 4, 10_000, (8, 1_252, 40_016, hr_mod.PLANE, 256)),
    (64, 10_000, (4, 2_500, 40_016, hr_mod.PLANE, 256)),
    (200, 10_000, (1, 10_000, 40_016, hr_mod.PLANE, 256)),
    (6, 45, (6, 8, 208, hr_mod.PLANE, 1_024)),
    (1, 1, (1, 4, 32, hr_mod.PLANE, 1_024)),
    (1, 58_108, (8, 7_264, SMEM, hr_mod.PLANE, 1_024)),
    (32, 58_112, (8, 7_264, 0, hr_mod.DEVICE, 256)),
    (41, 100_000, (6, 16_667, 0, hr_mod.DEVICE, 256)),
    (8, 500_000, (8, 62_500, 0, hr_mod.DEVICE, 1_024)),
    (1, 1_000_000, (8, 125_000, 0, hr_mod.DEVICE, 1_024)),
]


@pytest.mark.parametrize("rows,n,want", ROUND_GEOMETRY)
def test_health_round_geometry_is_a_cluster_per_row(rows, n, want):
    g = hr_mod.round_geometry(rows, n, 132, SMEM)
    assert tuple(g) == want
    assert g.cs * g.chunk >= n > (g.cs - 1) * g.chunk
    assert g.smem <= SMEM and g.cs <= hr_mod.MAX_CLUSTER
    assert (g.smem == -(-n // 4) * 16 + hr_mod.FLAG_BYTES
            if g.mode == hr_mod.PLANE else g.smem == 0)
    assert g.threads & (g.threads - 1) == 0 and g.cs * g.threads <= 8_192


#: (K, V, N, blocks per SM, blocks): the traffic form at M=256 of N=10,000
#: (its 2,560,000 value-row pruners fill a wave), at V=0 (a block per 32
#: nodes) and on 4 lanes of M=32 (one wave)
@pytest.mark.parametrize("k,v,n,per_sm,want", [
    (1, 256, 10_000, 6, 132 * 6), (1, 0, 10_000, 8, 313),
    (4, 32, 10_000, 3, 132 * 3)])
def test_health_round_traffic_grid_is_at_most_one_wave(k, v, n, per_sm, want):
    assert hr_mod.traffic_grid(k, v, n, 132, per_sm) == want


def test_health_round_packs_one_record_per_lane():
    k, its, gates = hr_mod.lane_values(32, 19, 1)
    assert k == 1 and its.tolist() == [19] and gates.tolist() == [1]
    k, its, gates = hr_mod.lane_values(24, np.array([5, 9, 40]),
                                       np.array([True, False, True]))
    assert k == 3 and its.tolist() == [5, 9, 40]
    assert gates.tolist() == [1, 0, 1]
    recs = hr_mod._lanes.pack(k, hr_mod.LANE_DTYPE, it=its, gate=gates)
    assert recs.itemsize == 16 and recs["it"].tolist() == [5, 9, 40]
    with pytest.raises(ValueError, match="do not split"):
        hr_mod.lane_values(10, np.array([1, 2, 3]), 1)


#: (P, N, wide, tiles per row, blocks at 8 a SM): the sim stack [8,
#: 10,000], the traffic stack [9, 10,000] (a block per 8 (row, digit)
#: scan warps: 9 x 32), [8, 100,000] (a block per tile), N = 1, N one past
#: a tile, a wide stack past one wave
DIGEST_GEOMETRY = [
    (8, 10_000, False, 10, 256),
    (9, 10_000, False, 10, 288),
    (8, 100_000, False, 98, 784),
    (8, 100_000, True, 98, 784),
    (2, 1, True, 1, 64),
    (2, 1_025, False, 2, 64),
    (41, 100_000, True, 98, 132 * 8),
]


@pytest.mark.parametrize("p,n,wide,tpr,blocks", DIGEST_GEOMETRY)
def test_health_digest_geometry_and_scratch(p, n, wide, tpr, blocks):
    """The digest's tiles and grid, and its scratch regions: 256-byte
    aligned, disjoint, each as large as its array (two key buffers of u32
    or u64 and two of i32 ids over [P, N], the tile stats, the [P, 256,
    tiles] counts, a total per (row, pass, digit) for 4 or 8 passes)."""
    g = hd_mod.launch_geometry(p, n, 132, 8)
    assert (g.tiles_per_row, g.blocks) == (tpr, blocks)
    assert (tpr - 1) * hd_mod.TILE < n <= tpr * hd_mod.TILE
    lay = hd_mod.scratch_layout(p, n, wide)
    key = 8 if wide else 4
    want = {"keys": 2 * p * n * key, "ids": 2 * p * n * 4,
            "tstat": p * tpr * 13 * 8, "counts": p * 256 * tpr * 4,
            "totals": p * key * 256 * 4, "rowmax": p * 8, "rowpasses": p * 4,
            "ctrl": 4}
    end = 0
    for name, size in want.items():
        off, got = lay[name]
        assert got == size and off % 256 == 0 and off >= end, name
        end = off + size
    assert end <= lay["total"] < end + 256
