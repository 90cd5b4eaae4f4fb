"""The arithmetic of the ``flash_decode`` CUDA kernel, mirrored in torch on
the CPU (a CUDA kernel has no CPU mode), against the plain version and
the JAX package's ``ops.flash_decode`` on the same numpy inputs.

The mirror follows ``kernels/csrc/flash_decode.cu`` step for step:
streams (KV head, head group of gb query heads), units of T live
positions of one row for SB adjacent streams, ordered (b, stream block,
tile); ``grid`` blocks each taking an equal contiguous share of at least
2 units, which may cross rows; each stream's WP warps taking the chunks
of 32 / gb positions of every unit round robin, each warp an online
softmax; a partial (m, l, acc) per (block, segment, warp) in the slot the
kernel writes, and the merge of a stream's partials by the last one,
with the kernel's count and slot formulas. It checks that those formulas
name exactly the partials written and that no two partials share a slot.

Tolerance 1e-5: fp32 summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MAX_TILE, MIN_TILES, NEG = 16, 2, -1e30


def stream_block(kvh, ng, warps=8):
    """-> SB, the host's choice: the most streams (<= warps) that are
    whole KV heads or part of one."""
    return max(d for d in range(1, warps + 1)
               if ng % d == 0 or (d % ng == 0 and kvh % (d // ng) == 0))


class Plan:
    """The unit space of one launch (``Plan`` and ``Cursor`` of the
    kernel)."""

    def __init__(self, lens, t, sbn, grid):
        tiles = [-(-n // t) for n in lens]
        self.pre = [0] + [int(x) for x in np.cumsum(tiles)]
        self.sbn = sbn
        self.U = sbn * self.pre[-1]
        self.n = min(grid, -(-self.U // MIN_TILES))

    def tiles(self, b):
        return self.pre[b + 1] - self.pre[b]

    def share(self, i):
        return i * self.U // self.n

    def segment_begin(self, seg):
        b, sb = divmod(seg, self.sbn)
        return self.sbn * self.pre[b] + sb * self.tiles(b)

    def first_block(self, g0):
        return ((g0 + 1) * self.n - 1) // self.U

    def last_block(self, g1):
        return (g1 * self.n - 1) // self.U

    def unit(self, u):
        b = 0
        while self.sbn * self.pre[b + 1] <= u:
            b += 1
        sb, tile = divmod(u - self.sbn * self.pre[b], self.tiles(b))
        return b, sb, tile


def mirror_flash_decode(q, k, v, cur_len, *, grid, gb, t=8, warps=8):
    """The kernel's split, online softmax and merge on CPU tensors."""
    b_, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    ng = -(-g // gb)
    sb_ = stream_block(kvh, ng, warps)
    wp = warps // sb_
    nw = sb_ * wp
    tc = min(32, MAX_TILE * gb) // gb
    lens = [min(max(int(n), 0), s) for n in
            torch.as_tensor(cur_len).reshape(-1).expand(b_).tolist()]
    pl = Plan(lens, t, kvh * ng // sb_, grid)
    out = torch.zeros(b_, h, dh)
    parts, written, tickets = {}, {}, {}
    qs = q * dh ** -0.5

    def stream(seg, sl):
        b, sb = divmod(seg, pl.sbn)
        kh, hg = divmod(sb * sb_ + sl, ng)
        return b, kh, kh * g + hg * gb, min(gb, g - hg * gb)

    def flush(i, seg, sl, ps, m, l, acc):
        b, kh, h0, nh = stream(seg, sl)
        g0 = pl.segment_begin(seg)
        first = pl.first_block(g0)
        count = (pl.last_block(g0 + pl.tiles(b)) - first + 1) * wp
        if count == 1:
            out[b, h0:h0 + nh] = acc / l[:, None]
            return
        p = b * kvh * ng + (seg % pl.sbn) * sb_ + sl
        slot = (i + seg) * nw + sl + sb_ * ps
        assert slot not in parts and slot < (grid + b_ * kvh * ng) * 8
        parts[slot] = (m, l, acc)
        written.setdefault(p, set()).add(slot)
        tickets[p] = tickets.get(p, 0) + 1
        if tickets[p] < count:
            return
        slots = [(first + kk // wp + seg) * nw + sl + sb_ * (kk % wp)
                 for kk in range(count)]
        assert sorted(slots) == sorted(written[p])
        mx = torch.stack([parts[x][0] for x in slots]).max(dim=0).values
        wt = [torch.exp(parts[x][0] - mx) for x in slots]
        den = sum(wk * parts[x][1] for wk, x in zip(wt, slots))
        num = sum(wk[:, None] * parts[x][2] for wk, x in zip(wt, slots))
        out[b, h0:h0 + nh] = num / den[:, None]
        tickets[p] = 0

    for i in range(pl.n):
        u0, u1 = pl.share(i), pl.share(i + 1)
        for w in range(nw):
            sl, ps = w % sb_, w // sb_
            cur = None
            for j in range(u1 - u0):
                b, sb, tile = pl.unit(u0 + j)
                seg = b * pl.sbn + sb
                if cur is None or cur[0] != seg:
                    if cur is not None:
                        flush(i, cur[0], sl, ps, *cur[1:])
                    nh = stream(seg, sl)[3]
                    cur = [seg, torch.full((nh,), NEG), torch.zeros(nh),
                           torch.zeros(nh, dh)]
                _, kh, h0, nh = stream(seg, sl)
                t0 = tile * t
                n = min(t, lens[b] - t0)
                for c0 in range(ps * tc, n, wp * tc):
                    c1 = min(n, c0 + tc)
                    kt = k[b, t0 + c0:t0 + c1, kh]          # [<=tc, dh]
                    vt = v[b, t0 + c0:t0 + c1, kh]
                    sc = qs[b, h0:h0 + nh] @ kt.T            # [nh, <=tc]
                    _, m, l, acc = cur
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    pr = torch.exp(sc - m_new[:, None])
                    cur[1] = m_new
                    cur[2] = l * alpha + pr.sum(dim=1)
                    cur[3] = acc * alpha[:, None] + pr @ vt
            if cur is not None:
                flush(i, cur[0], sl, ps, *cur[1:])
    assert all(x == 0 for x in tickets.values())
    return out


def _inputs(seed, b, s, kvh, g, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, g * kvh, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
@pytest.mark.parametrize("kvh,g,gb,t", [
    (2, 1, 1, 16), (2, 4, 4, 8), (2, 4, 2, 8), (2, 3, 4, 4), (2, 8, 8, 16),
    (8, 4, 4, 8),                   # llama3-8b's grouping: one stream a warp
    (3, 2, 1, 8),                   # SB 6 streams of 3 KV heads, 6 warps
    (1, 32, 2, 8)])                 # 16 streams of one KV head, SB 8
def test_kernel_split_and_merge_match_plain_and_jax(grid, kvh, g, gb, t):
    """Shares that cross rows, rows that end mid-tile and at a tile
    boundary, a length past S (clamped), head groups narrower than G and
    padded (3 of 4), several warps a stream and units of part of one KV
    head's streams."""
    b, s, dh = 4, 70, 16
    q, k, v = _inputs(30 + g, b, s, kvh, g, dh)
    cur = np.array([1, 32, 45, 99], np.int32)
    got = mirror_flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(cur),
                              grid=grid, gb=gb, t=t)
    plain = tref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(cur))
    want = np.asarray(jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        jnp.asarray(np.minimum(cur, s))))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("grid", [2, 132])
def test_kernel_split_long_row_and_scalar_cur_len(grid):
    """B 1 with one long row (one group spread over every block) and a
    scalar ``cur_len``."""
    q, k, v = _inputs(40, 1, 700, 1, 4, 8)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    for cur in (700, 513):
        got = mirror_flash_decode(*args, cur, grid=grid, gb=4, t=16)
        np.testing.assert_allclose(
            got.numpy(), tref.flash_decode_ref(*args, cur).numpy(),
            atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.flash_decode(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.int32(cur))), atol=1e-5, rtol=0)


def test_kernel_split_writes_zeros_at_cur_len_zero():
    """A row at cur_len 0 has no tiles and gets zeros (the TPU kernel's
    acc / max(l, 1e-30)); the other rows are unchanged by it."""
    q, k, v = _inputs(41, 3, 40, 2, 2, 8)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    cur = torch.tensor([0, 17, 40], dtype=torch.int32)
    got = mirror_flash_decode(*args, cur, grid=5, gb=2)
    assert bool((got[0] == 0).all())
    np.testing.assert_allclose(
        got[1:].numpy(), tref.flash_decode_ref(*args, cur)[1:].numpy(),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("g,dh,vec,want", [
    (4, 128, 1, (4, 1)), (8, 128, 1, (8, 1)), (16, 128, 1, (8, 2)),
    (3, 128, 1, (4, 1)), (8, 256, 1, (4, 2)), (1, 64, 1, (1, 1)),
    (2, 1024, 1, (1, 2)), (4, 30, 0, (1, 4))])
def test_flash_plan_head_groups(monkeypatch, g, dh, vec, want):
    """The wrapper's head groups keep a lane's q and acc in registers
    (gb x lane columns <= 1024 floats); the grid is one block per SM."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(tops._SMS, dev, 132)
    assert tops._flash_plan(g, dh, vec, dev) == (*want, 132)
