"""The arithmetic of K2's, K3's and K4's Hopper designs, emulated on the
CPU.

Neither kernel runs here, so each design's algorithm is written out in
numpy as the kernel runs it and held against the JAX package's Pallas
kernel in interpret mode and against the plain versions:

* K2 (``csrc/byteplanes.cu::shuffle_reg``): a thread owns 16 consecutive
  elements of one page; its warp loads the 32 x 16 nb bytes coalesced
  and stages them in shared memory under an XOR swizzle, the thread reads
  back its 16 x nb bytes as 4 nb words and transposes them with
  ``__byte_perm`` in the kernel's selector schedule into nb plane vectors
  of 16 bytes;
* K3 (``csrc/byteplanes.cu::unsplit_reg``), K2 run backwards: a thread
  owns 16 consecutive elements of one page, loads one 16-byte vector from
  each of the nb planes, transposes them with ``__byte_perm``
  (``elems_of``) into nb element-major chunks, stages them under K2's XOR
  swizzle, and its warp's lanes store the warp's 32 nb chunks coalesced;
* K4 (``csrc/scans.cu::decode_offsets_cluster``): a page is one cluster
  of C blocks (``decode_pages.launch_shape``); each round rank r scans
  its tile (the thread's 8 elements from two 4 x 4 byte transposes,
  un-zigzagged and scanned, then a block scan of the thread totals),
  adds the totals of the ranks before it and the running carry of the
  earlier rounds.

Change an emulation together with its kernel.  Inputs are made with numpy
from a seed; every comparison is exact.  The kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.byteshuffle import byteshuffle_pages as j_byteshuffle_pages
from repro.kernels.decode_pages import (
    decode_offset_pages as j_decode_offset_pages,
    unsplit_pages as j_unsplit_pages,
)

from repro_torch.kernels import ref
from repro_torch.kernels.decode_pages import (
    DECODE_ITEMS, DECODE_THREADS, DECODE_TILE, MAX_CLUSTER, launch_shape,
)

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

U32 = np.uint64(0xFFFFFFFF)


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: result byte n is
    byte ``(s >> 4n) & 7`` of the pair, x's bytes numbered 0-3 and y's
    4-7."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    pair = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    pair += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for n in range(4):
        out |= pair[(s >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def transpose4x4(w):
    """``repro::transpose4x4`` (csrc/common.cuh): the same eight
    selectors."""
    t0 = byte_perm(w[0], w[1], 0x5140)
    t1 = byte_perm(w[0], w[1], 0x7362)
    t2 = byte_perm(w[2], w[3], 0x5140)
    t3 = byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def planes_of(w, nb: int):
    """``planes_of<NB>`` (csrc/byteplanes.cu): 4 nb element-major words
    of 16 elements -> nb planes of 4 words."""
    if nb == 1:
        return [[w[q] for q in range(4)]]
    if nb == 2:
        return [[byte_perm(w[2 * q], w[2 * q + 1], sel) for q in range(4)]
                for sel in (0x6420, 0x7531)]
    o = [[None] * 4 for _ in range(nb)]
    for q in range(4):
        for h in range(nb // 4):  # nb 4: one block; nb 8: two halves
            if nb == 4:
                rows = [w[4 * q + k] for k in range(4)]
            else:
                rows = [w[8 * q + 2 * k + h] for k in range(4)]
            for m, word in enumerate(transpose4x4(rows)):
                o[4 * h + m][q] = word
    return o


def shuffle_reg_emulation(pages: np.ndarray) -> np.ndarray:
    """K2's register form on (P, per, nb) uint8 pages, per % 16 == 0:
    thread g loads words [4 nb g, 4 nb g + 4 nb) and stores plane j's 16
    bytes at page * per * nb + j * per + e0.  Every output byte must be
    written exactly once."""
    n_pages, per, nb = pages.shape
    assert per % 16 == 0
    n_threads = n_pages * per // 16
    words = np.ascontiguousarray(pages).reshape(-1).view("<u4")
    words = words.reshape(n_threads, 4 * nb)
    g = np.arange(n_threads)
    page = g // (per // 16)
    e0 = (g - page * (per // 16)) * 16
    o = planes_of([words[:, i] for i in range(4 * nb)], nb)
    out = np.zeros(n_pages * nb * per, np.uint8)
    hits = np.zeros(out.size, np.int64)
    for j in range(nb):
        vec = np.stack(o[j], axis=1).astype("<u4").view(np.uint8)  # (T, 16)
        at = (page * per * nb + j * per + e0)[:, None] + np.arange(16)
        out[at] = vec
        np.add.at(hits, at.reshape(-1), 1)
    assert (hits == 1).all(), "K2's threads must cover each byte once"
    return out.reshape(n_pages, nb, per)


def elems_of(o, nb: int):
    """``elems_of<NB>`` (csrc/byteplanes.cu), the inverse of ``planes_of``:
    nb planes of 4 words -> 4 nb element-major words of 16 elements."""
    if nb == 1:
        return [o[0][q] for q in range(4)]
    w = [None] * (4 * nb)
    for q in range(4):
        if nb == 2:
            w[2 * q] = byte_perm(o[0][q], o[1][q], 0x5140)
            w[2 * q + 1] = byte_perm(o[0][q], o[1][q], 0x7362)
            continue
        for h in range(nb // 4):  # nb 4: one block; nb 8: two halves
            cols = transpose4x4([o[4 * h + k][q] for k in range(4)])
            for m, word in enumerate(cols):
                w[4 * q + m if nb == 4 else 8 * q + 2 * m + h] = word
    return w


def unsplit_reg_emulation(planes: np.ndarray) -> np.ndarray:
    """K3's register form on (P, nb, per) uint8 planes, per % 16 == 0:
    thread g loads plane j's 16 bytes at page * per * nb + j * per + e0,
    turns them into nb element-major chunks, which its warp stages (slot
    ``stage_slot(nb lane + k)``) and stores as chunk 32 k + lane of the
    warp's.  Every output byte must be written exactly once."""
    n_pages, nb, per = planes.shape
    assert per % 16 == 0
    n_threads = n_pages * per // 16
    flat = np.ascontiguousarray(planes).reshape(-1)
    g = np.arange(n_threads)
    page = g // (per // 16)
    e0 = (g - page * (per // 16)) * 16
    o = []
    for j in range(nb):
        at = (page * per * nb + j * per + e0)[:, None] + np.arange(16)
        vec = flat[at].view("<u4")  # (T, 4)
        o.append([vec[:, q] for q in range(4)])
    w = np.stack(elems_of(o, nb), axis=1).astype("<u4")  # (T, 4 nb)
    chunks = w.reshape(n_threads, nb, 4)  # thread g's chunk k
    n_warps = -(-n_threads // 32)
    stage = np.zeros((n_warps, 32 * nb, 4), np.uint32)
    lane = g % 32
    for k in range(nb):
        stage[g // 32, stage_slot(nb * lane + k)] = chunks[:, k]
    out = np.zeros((n_threads * nb, 4), np.uint32)
    hits = np.zeros(n_threads * nb, np.int64)
    for warp in range(n_warps):
        for k in range(nb):
            c = 32 * k + np.arange(32)
            dst = warp * 32 * nb + c
            ok = dst < n_threads * nb
            out[dst[ok]] = stage[warp, stage_slot(c[ok])]
            hits[dst[ok]] += 1
    assert (hits == 1).all(), "K3's lanes must store each chunk once"
    return out.astype("<u4").view(np.uint8).reshape(n_pages, per, nb)


def stage_slot(c):
    """The shared-memory slot of a warp's 16-byte chunk ``c`` in K2's
    staging: bits 0-2 XORed with bits 3-5."""
    return c ^ ((c >> 3) & 7)


def unzigzag(z):
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)) ^ ((np.uint64(0) - (z & np.uint64(1))) & U32)) & U32


def element_words(planes: np.ndarray, page: int, e: np.ndarray):
    """(T, 8) uint32 words of the threads' 8 elements ``e`` (T, 8) of one
    page, as K4 forms them: on the vector path (``per % 8 == 0`` and the
    thread's 8 elements inside the page) an 8-byte load from each of the
    four low planes, two uint32 each, turned into element words by two
    4 x 4 transposes; otherwise one byte per plane and element."""
    per = planes.shape[2]
    ee = np.minimum(e, per - 1)  # rows past the page are masked by callers
    b = [planes[page, j][ee].astype(np.uint32) for j in range(4)]  # (T, 8)
    lo = [b[j][:, 0] | b[j][:, 1] << 8 | b[j][:, 2] << 16 | b[j][:, 3] << 24
          for j in range(4)]
    hi = [b[j][:, 4] | b[j][:, 5] << 8 | b[j][:, 6] << 16 | b[j][:, 7] << 24
          for j in range(4)]
    vec = np.stack(transpose4x4(lo) + transpose4x4(hi), axis=1)
    scalar = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24
    full = (per % DECODE_ITEMS == 0) & (e[:, -1] < per)
    return np.where(full[:, None], vec, scalar)


def cluster_decode_emulation(planes: np.ndarray):
    """K4's cluster design on (P, 8, per) uint8 planes -> ((P, per) int32,
    rounds a page).  Sums in uint32, wrapping; every element must be
    written exactly once."""
    n_pages, _, per = planes.shape
    c, tile = launch_shape(per)
    lanes = (np.arange(DECODE_THREADS)[:, None] * DECODE_ITEMS
             + np.arange(DECODE_ITEMS))  # (T, 8) offsets in a tile
    out = np.zeros((n_pages, per), np.uint64)
    hits = np.zeros((n_pages, per), np.int64)
    rounds = list(range(0, per, c * tile))
    for page in range(n_pages):
        carry = 0
        for r0 in rounds:
            local, totals = [], []
            for rank in range(c):
                e = r0 + rank * tile + lanes
                s = np.where(e < per, unzigzag(element_words(planes, page, e)), 0)
                s = np.cumsum(s.astype(np.uint64), axis=1) & U32  # thread scan
                incl = np.cumsum(s[:, -1]) & U32                   # block scan
                local.append((e, s, (incl - s[:, -1]) & U32))
                totals.append(int(incl[-1]))
            # after cluster.sync(): rank r adds the totals of ranks < r
            for rank, (e, s, excl) in enumerate(local):
                pre = np.uint64((carry + sum(totals[:rank])) & 0xFFFFFFFF)
                vals = (pre + excl[:, None] + s) & U32
                m = e < per
                out[page, e[m]] = vals[m]
                hits[page, e[m]] += 1
            carry = (carry + sum(totals)) & 0xFFFFFFFF
    assert (hits == 1).all(), "K4's ranks must cover each element once"
    return out.astype(np.uint32).view(np.int32), len(rounds)


# ---------------------------------------------------------------------------
# K2


def test_byte_perm_and_transpose_follow_the_cuda_definitions():
    # bytes 0x00..0x07 of the pair: a selector picks them by number
    x, y = np.uint32(0x03020100), np.uint32(0x07060504)
    assert byte_perm(x, y, 0x3210) == 0x03020100
    assert byte_perm(x, y, 0x7654) == 0x07060504
    assert byte_perm(x, y, 0x5140) == 0x05010400
    # rows a..d of bytes 0xR0..0xR3 -> columns
    rows = [np.uint32(int.from_bytes(bytes([16 * r + k for k in range(4)]),
                                     "little")) for r in range(4)]
    cols = transpose4x4(rows)
    for j in range(4):
        assert int(cols[j]).to_bytes(4, "little") == bytes(
            [16 * r + j for r in range(4)])


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("n_pages,per", [(1, 16), (3, 64), (2, 1024)])
def test_byteshuffle_pages_register_form_matches_pallas(nb, n_pages, per):
    rng = np.random.default_rng(1000 * nb + per + n_pages)
    pages = rng.integers(0, 256, (n_pages, per, nb), dtype=np.uint8)
    got = shuffle_reg_emulation(pages)
    pal = np.asarray(j_byteshuffle_pages(jnp.asarray(pages), interpret=True))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(
        got, ref.byteshuffle_pages_ref(torch.from_numpy(pages)).numpy())
    orc = np.stack([np.asarray(jref.byteshuffle_ref(jnp.asarray(p)))
                    for p in pages])
    np.testing.assert_array_equal(got, orc)


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_byteshuffle_register_form_as_one_page_matches_k9_plain(nb):
    """K9 runs through the same code as one page of per = N."""
    rng = np.random.default_rng(77 + nb)
    planes = rng.integers(0, 256, (4096, nb), dtype=np.uint8)
    got = shuffle_reg_emulation(planes[None])[0]
    np.testing.assert_array_equal(
        got, ref.byteshuffle_ref(torch.from_numpy(planes)).numpy())


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("n_pages,per", [(1, 16), (3, 64), (2, 1024),
                                         (5, 48)])
def test_unsplit_pages_register_form_matches_pallas(nb, n_pages, per):
    """K3's register form (ragged last warp at (1, 16) and (5, 48)) against
    the Pallas kernel in interpret mode, the plain version, and K2's
    register form run forwards."""
    rng = np.random.default_rng(2000 * nb + per + n_pages)
    planes = rng.integers(0, 256, (n_pages, nb, per), dtype=np.uint8)
    got = unsplit_reg_emulation(planes)
    pal = np.asarray(j_unsplit_pages(jnp.asarray(planes), interpret=True))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(
        got, ref.unsplit_pages_ref(torch.from_numpy(planes)).numpy())
    np.testing.assert_array_equal(shuffle_reg_emulation(got), planes)


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_byteshuffle_pages_staging_is_exact_and_conflict_free(nb):
    """K2's warp staging: lane l stores chunk 32 k + l (coalesced loads)
    and reads back chunk nb l + k, its own (K3 the other way round: its
    own chunks in, chunk 32 k + l out to a coalesced store).  The slots are a permutation
    of the warp's 32 nb (no chunk overwrites another), and in every
    16-byte access of a quarter-warp (8 lanes) the 8 lanes hit 8
    different 16-byte bank groups, storing and loading."""
    lanes = np.arange(32)
    stored = np.concatenate([stage_slot(32 * k + lanes) for k in range(nb)])
    assert sorted(stored) == list(range(32 * nb))
    for k in range(nb):
        reads = nb * lanes + k
        for q in range(4):
            quarter = slice(8 * q, 8 * q + 8)
            for slots in (stage_slot(32 * k + lanes)[quarter],
                          stage_slot(reads)[quarter]):
                assert len(set(slots % 8)) == 8


# ---------------------------------------------------------------------------
# K4


def _zigzag_planes(rng, n_pages, per):
    """(P, 8, per) planes of uint32 zigzag values (planes 4..7 zero),
    random over the whole range with the extremes 0, 1, 2^31 - 1, 2^31,
    2^32 - 2 and 2^32 - 1 at every 5th position."""
    z = rng.integers(0, 2**32, (n_pages, per), dtype=np.uint64)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     dtype=np.uint64)
    z[:, ::5] = np.resize(edges, z[:, ::5].shape)
    b = z.astype("<u8").view(np.uint8).reshape(n_pages, per, 8)
    return np.ascontiguousarray(b.transpose(0, 2, 1))


@pytest.mark.parametrize("n_pages,per", [(3, 8192), (2, 1000), (1, 20000)])
def test_decode_offset_pages_cluster_form_matches_pallas(n_pages, per):
    rng = np.random.default_rng(per + n_pages)
    planes = _zigzag_planes(rng, n_pages, per)
    got, rounds = cluster_decode_emulation(planes)
    c, tile = launch_shape(per)
    assert rounds == -(-per // (c * tile))
    pal = np.asarray(j_decode_offset_pages(jnp.asarray(planes),
                                           interpret=True))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(
        got, ref.decode_offset_pages_ref(torch.from_numpy(planes)).numpy())


def test_decode_offset_pages_cluster_form_on_the_read_path_data():
    """End offsets below 2^31, as the reader routes them, at the read
    path's page width and at a page of 2^20 that loops 128 rounds."""
    rng = np.random.default_rng(5)
    for n_pages, per in [(2, 8192), (1, 1 << 20)]:
        ends = rng.integers(0, 2**31, (n_pages, per), dtype=np.int64)
        d = np.diff(ends, axis=1, prepend=0)
        zz = ((d << 1) ^ (d >> 63)).astype(np.uint64)
        planes = np.ascontiguousarray(
            zz.view(np.uint8).reshape(n_pages, per, 8).transpose(0, 2, 1))
        got, rounds = cluster_decode_emulation(planes)
        np.testing.assert_array_equal(got.astype(np.int64), ends)
    assert rounds == (1 << 20) // (MAX_CLUSTER * DECODE_TILE)


# ---------------------------------------------------------------------------
# launch geometry


@pytest.mark.parametrize("per", [1, 5, 8, 1000, 1023, 1024, 1025, 4099,
                                 8192, 8193, 20000, 1 << 20])
def test_decode_offset_pages_launch_geometry(per):
    c, tile = launch_shape(per)
    assert 1 <= c <= MAX_CLUSTER and tile == DECODE_THREADS * DECODE_ITEMS
    n_pages = 3
    grid = n_pages * c
    assert grid % c == 0
    # block b: page b // c, rank b % c; each round rank r takes its tile
    seen = np.zeros((n_pages, per), np.int64)
    for b in range(grid):
        page, rank = divmod(b, c)
        for r0 in range(0, per, c * tile):
            lo = r0 + rank * tile
            seen[page, lo:min(lo + tile, per)] += 1
    assert (seen == 1).all()
    # no more blocks than the page has tiles, up to the cluster limit
    assert c == min(MAX_CLUSTER, -(-per // tile))


def test_launch_shape_refuses_an_empty_page():
    with pytest.raises(ValueError):
        launch_shape(0)
