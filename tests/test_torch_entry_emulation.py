"""The int8 entry kernel (``csrc/fused_entry.cu``) emulated on the CPU, step
by step as the card runs it: the planner's (band, strip, step) walk, the
rings of image rows in shared memory with the rows each carries into the
next step, the flattened layout whose taps are constant row offsets, the
128-byte swizzle the epilogue writes and ``wgmma`` reads, the stem's four
polyphase planes and its im2col K of 108 -> 128, the zero masking at every
edge, the int32 accumulators and the epilogue.  Shared memory starts full of
random bytes, so a value the kernel reads before it writes it shows up.

Held bit-equal to the plain version (``fused_entry_ref``) and, on
``tests/test_entry_kernel.py``'s DIM-96 fixture, within that file's bound of
the Pallas ``fused_entry`` in interpret mode.  On the card the kernel itself
is held to the plain version (``tests/test_torch_cuda_kernels.py``)."""

import contextlib

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_entry_kernel import _within_entry_bound, qnet  # noqa: F401 (fixture)
from yolo_v3_tpu.ops import entry_kernel as JEK
from yolo_v3_tpu_torch.models.quantized import qtree_from_numpy
from yolo_v3_tpu_torch.ops import entry_kernel as EK
from yolo_v3_tpu_torch.ops.fused_conv import epilogue_ref, k_major

# the kernel's constants and shared-memory layout (offsets from a
# 1024-byte-aligned base, so that an offset's bits are the address bits the
# swizzle reads)
ROW, P1, WS, S, TILE = 128, EK.RING_WIDTH, EK.STRIP, EK.STEP, 64
POS = S * P1
NS, SLOT = 6, 128 * ROW
PLANE = (S + 1) * P1 * ROW
R1_BYTES = (S + 2) * P1 * ROW
OFF_COL = NS * SLOT
OFF_PLANES = OFF_COL + 2 * TILE * ROW
OFF_D0 = OFF_PLANES + 4 * PLANE
OFF_R1 = OFF_D0 + 2 * PLANE
OFF_R2 = OFF_R1 + R1_BYTES
OFF_MB = OFF_R2 + 2 * PLANE + 1024     # each conv's (m, b) pairs
OFF_BAR = OFF_MB + 896 * 8
SMEM = 1024 + OFF_BAR + 2 * NS * 8


def _rows_index(start, n):
    """Byte offsets of the n 128-byte rows from ``start``, in the 128-byte
    swizzle: chunk j of the row at offset a lies at chunk j ^ ((a >> 7) & 7)."""
    rows = start + ROW * np.arange(n)[:, None]
    byte = np.arange(ROW)[None, :]
    return rows + 16 * (((byte >> 4) ^ (rows >> 7)) & 7) + (byte & 15)


class _Smem:
    def __init__(self, rng):
        self.b = rng.integers(-128, 128, SMEM - 1024, dtype=np.int8)

    def read(self, start, n=TILE):
        """A wgmma operand: n rows from ``start`` as [n, 128] int8."""
        return self.b[_rows_index(start, n)]

    def write(self, start, rows):
        self.b[_rows_index(start, len(rows))] = rows


def _weights(qs2d):
    """Each conv's K-major weight [N, K] as the wrapper hands it over (the
    stem's 108 columns padded to 128), cut into K slices of 128: {(name,
    k0): float32 [128, N]}.  A slice's products and partial sums are
    integers below 2^24 (128 * 128 * 127), so float32 sums them exactly."""
    out = {}
    for name in EK.CONVS:
        w = EK._w4(qs2d[name]["w"])
        wk = (EK.stem_k128(w) if name == "stem"
              else k_major(w, w.reshape(-1, w.shape[-1]))).numpy()
        for k0 in range(0, wk.shape[1], 128):
            out[name, k0] = np.ascontiguousarray(wk[:, k0:k0 + 128].T, np.float32)
    return out


def _acc(a, wk, name, k0):
    """int32 accumulator of [64, 128] int8 A times conv ``name``'s K slice
    from k0."""
    return (a.astype(np.float32) @ wk[name, k0]).astype(np.int32)


def _epi(acc, qs2d, name, inside, residual=None, res_scale=1.0):
    p = qs2d[name]
    y = epilogue_ref(torch.from_numpy(acc), p["m"], p["b"],
                     residual=None if residual is None else torch.from_numpy(residual),
                     res_scale=res_scale, valid=torch.from_numpy(inside)[:, None])
    return y.numpy()


@contextlib.contextmanager
def _one_thread():
    """The emulation's products are small: threads only contend for them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(before)


def emulate(xb, qs2d, res_scale, band, seed=0):
    """The kernel's output for ``xb`` [B, 2h+2, 2w+2, 12] with band height
    ``band``, and how often each output position was stored."""
    with _one_thread():
        return _emulate(xb, qs2d, res_scale, band, seed)


def _emulate(xb, qs2d, res_scale, band, seed):
    xb = xb.numpy()
    bsz, hx, wx, _ = xb.shape
    h, w = (hx - 2) // 2, (wx - 2) // 2
    wk = _weights(qs2d)
    out = np.zeros((bsz, h, w, 128), np.int8)
    stores = np.zeros((bsz, h, w), np.int32)
    smem = _Smem(np.random.default_rng(seed))
    f = np.arange(TILE)
    frow, j, used = f // P1, f % P1, f < POS
    strips, bands = -(-w // WS), -(-h // band)
    carry = ([OFF_PLANES + p * PLANE for p in range(4)] + [OFF_D0, OFF_D0 + PLANE]
             + [OFF_R1, OFF_R1 + P1 * ROW] + [OFF_R2, OFF_R2 + PLANE])
    for u in range(bsz * bands * strips):
        strip, bnd, img = u % strips, (u // strips) % bands, u // (strips * bands)
        c0, r0 = strip * WS, bnd * band
        rows = min(band, h - r0)
        for t in range(EK.band_steps(rows)):
            q0 = r0 - 3 + t * S
            for dst in carry:             # the carried rows to the ring's head
                smem.write(dst, smem.read(dst + POS * ROW, P1))
            # stem: im2col of each plane (py, px) = (p >> 1, p & 1), a 1x1
            for rnd in range(2):
                for tt in range(2):
                    p = 2 * rnd + tt
                    y = 2 * (q0 + frow) + (p >> 1)
                    x = 2 * (c0 - 3 + j) + (p & 1)
                    inside = used & (y >= 0) & (y < 2 * h) & (x >= 0) & (x < 2 * w)
                    col = np.zeros((TILE, ROW), np.int8)
                    r = np.flatnonzero(inside)
                    ys = y[r, None, None] + np.arange(3)[None, :, None]
                    xs = x[r, None, None] + np.arange(3)[None, None, :]
                    col[r, :108] = xb[img, ys, xs].reshape(len(r), 108)
                    smem.write(OFF_COL + tt * TILE * ROW, col)
                for tt in range(2):
                    p = 2 * rnd + tt
                    y = 2 * (q0 + frow) + (p >> 1)
                    x = 2 * (c0 - 3 + j) + (p & 1)
                    inside = (y >= 0) & (y < 2 * h) & (x >= 0) & (x < 2 * w)
                    acc = _acc(smem.read(OFF_COL + tt * TILE * ROW), wk, "stem", 0)
                    smem.write(OFF_PLANES + p * PLANE + P1 * ROW,
                               _epi(acc, qs2d, "stem", inside)[:POS])
            yq, xq = q0 + frow, c0 - 3 + j
            in_q = (yq >= 0) & (yq < h) & (xq >= 0) & (xq < w)
            in_r2 = (yq - 1 >= 0) & (yq - 1 < h) & (xq >= 0) & (xq < w)
            # down0: tap (u, v) is plane ((u + 1) & 1, (v + 1) & 1) shifted
            acc = np.zeros((TILE, 256), np.int32)
            for tap in range(9):
                du, dv = tap // 3, tap % 3
                p = 2 * ((du + 1) & 1) + ((dv + 1) & 1)
                a = smem.read(OFF_PLANES + p * PLANE
                              + (P1 - (P1 if du == 0 else 0) - (1 if dv == 0 else 0)) * ROW)
                acc += _acc(a, wk, "down0", 128 * tap)
            d0 = _epi(acc, qs2d, "down0", in_q)[:POS]
            for kp in range(2):
                smem.write(OFF_D0 + kp * PLANE + P1 * ROW, d0[:, 128 * kp:128 * kp + 128])
            # res0_1: down0 one ring row up
            acc = sum(_acc(smem.read(OFF_D0 + kp * PLANE + P1 * ROW), wk, "res0_1", 128 * kp)
                      for kp in range(2))
            smem.write(OFF_R1 + 2 * P1 * ROW, _epi(acc, qs2d, "res0_1", in_q)[:POS])
            # res0_2 with down0's residual
            acc = sum(_acc(smem.read(OFF_R1 + ((tap // 3) * P1 + tap % 3 - 1) * ROW),
                           wk, "res0_2", 128 * tap) for tap in range(9))
            res = np.concatenate([smem.read(OFF_D0 + kp * PLANE) for kp in range(2)], 1)
            r2 = _epi(acc, qs2d, "res0_2", in_r2, res, res_scale)[:POS]
            for kp in range(2):
                smem.write(OFF_R2 + kp * PLANE + P1 * ROW, r2[:, 128 * kp:128 * kp + 128])
            # down1: out rows [q0 - 1, q0 + S - 1)
            acc = sum(_acc(smem.read(OFF_R2 + kp * PLANE + ((tap // 2) * P1 + tap % 2 - 1)
                                     * ROW), wk, "down1", 256 * tap + 128 * kp)
                      for tap in range(4) for kp in range(2))
            o = _epi(acc, qs2d, "down1", np.ones(TILE, bool))
            yo = q0 - 1 + frow
            store = (used & (yo >= r0) & (yo < r0 + rows) & (j >= 3) & (j < 3 + WS)
                     & (xq < w))
            out[img, yo[store], xq[store]] = o[store]
            np.add.at(stores, (img, yo[store], xq[store]), 1)
    return torch.from_numpy(out), stores


def _random_inputs(b, h, w, seed=0):
    """The card tests' inputs (``tests/test_torch_cuda_kernels.py``)."""
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(rng.integers(-127, 128, (b, 2 * h + 2, 2 * w + 2, 12), dtype=np.int8))
    qs2d = {}
    for name, (kh, kw, cin, cout) in EK.SHAPES.items():
        shape = (cin, cout) if kh == 1 else (kh, kw, cin, cout)
        k = kh * kw * cin
        qs2d[name] = {
            "w": torch.from_numpy(rng.integers(-20, 20, shape, dtype=np.int8)),
            "m": torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 40.0
                                   / (np.sqrt(k) * 133.0)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(0, 3.0, cout).astype(np.float32))}
    return xb, qs2d


def _check(xb, qs2d, res_scale, band):
    got, stores = emulate(xb, qs2d, res_scale, band)
    assert (stores == 1).all()                   # every output position stored once
    want = EK.fused_entry_ref(xb, qs2d, res_scale)
    assert torch.equal(got, want), (got.int() - want.int()).abs().max()
    assert (got != 0).any()
    return got


@pytest.mark.parametrize("geometry", ["planned", "band24", "band5"])
def test_emulation_on_the_dim96_fixture(qnet, geometry):  # noqa: F811
    """h = w = 24: bit-equal to the plain version, and within
    tests/test_entry_kernel.py's bound of the Pallas kernel in interpret
    mode (whose epilogue, jitted, can move a rounding tie)."""
    qtree, xb, res_scale = qnet
    qs2d = qtree_from_numpy(jax.device_get(qtree["s2d"]))
    x = torch.from_numpy(np.array(xb))
    h = (x.shape[1] - 2) // 2
    if geometry == "planned":
        band = EK.plan_entry(x.shape[0], h, (x.shape[2] - 2) // 2)["band"]
    else:
        band = int(geometry[4:])
    got = _check(x, qs2d, res_scale, band)
    want = JEK.fused_entry(xb, qtree["s2d"], res_scale=res_scale, band=24, interpret=True)
    _within_entry_bound(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,h,w,band", [
    (1, 13, 21, 0),         # one strip narrower than WS, odd h
    (2, 7, 30, 0),          # w not a multiple of the strip: 26 + 4 columns
    (1, 9, 60, 4),          # 3 strips, the last 8 columns, bands of 4 and 1
    (1, 9, 60, 9),
    (2, 1, 5, 0),           # h below one step
    (1, 3, 27, 1),          # bands of one row, the second strip one column
])
def test_emulation_at_the_edges(b, h, w, band):
    xb, qs2d = _random_inputs(b, h, w)
    _check(xb, qs2d, 0.6, band or EK.plan_entry(b, h, w)["band"])


def test_emulation_batch1_at_416():
    """Batch 1 at the forward's h = w = 104, with the planner's geometry."""
    xb, qs2d = _random_inputs(1, 104, 104, seed=1)
    _check(xb, qs2d, 0.6, EK.plan_entry(1, 104, 104)["band"])


def _coverage(b, h, w, band):
    """Output positions stored by the kernel's walk (no arithmetic)."""
    stores = np.zeros((b, h, w), np.int32)
    strips, bands = -(-w // WS), -(-h // band)
    f = np.arange(POS)
    for u in range(b * bands * strips):
        strip, bnd, img = u % strips, (u // strips) % bands, u // (strips * bands)
        c0, r0 = strip * WS, bnd * band
        rows = min(band, h - r0)
        for t in range(EK.band_steps(rows)):
            yo, j = r0 - 4 + t * S + f // P1, f % P1
            x = c0 - 3 + j
            ok = (yo >= r0) & (yo < r0 + rows) & (j >= 3) & (j < 3 + WS) & (x < w)
            np.add.at(stores, (img, yo[ok], x[ok]), 1)
    return stores


@pytest.mark.parametrize("b,h,w", [(8, 104, 104), (1, 104, 104), (16, 104, 104),
                                   (8, 52, 52), (2, 24, 24), (1, 13, 21), (3, 7, 40),
                                   (1, 1, 1), (2, 152, 152)])
def test_planner_covers_every_output_once(b, h, w):
    plan = EK.plan_entry(b, h, w)
    assert 1 <= plan["band"] <= h
    assert plan["units"] == b * -(-h // plan["band"]) * -(-w // WS)
    assert (_coverage(b, h, w, plan["band"]) == 1).all()
    for band in (1, h, max(1, h // 3)):
        assert (_coverage(b, h, w, band) == 1).all()


def test_planner_shared_memory_and_picks():
    """The layout fits one block's 227 KB; at the int8 forward's shape
    (batch 8, 416: h = w = 104) the planner takes bands of 26 rows on the 4
    strips: 128 work items, one wave on 132 SMs, 15 steps a band."""
    assert SMEM == EK.SMEM_BYTES <= 232448
    assert P1 == WS + 4 and POS <= TILE
    assert EK.plan_entry(8, 104, 104) == dict(strip=26, step=2, band=26, units=128, steps=15)
    assert EK.plan_entry(16, 104, 104)["band"] == 52    # 2 bands: 128 items
    # one strip, 13 rows: bands of 2 (7 items, 3 steps) beat 1 (13 items,
    # as many steps) on total work, and 3 rows take 4 steps
    assert EK.plan_entry(1, 13, 21)["band"] == 2
    # a band's steps: its rows and the 3 rows above it, S at a time
    assert [EK.band_steps(r) for r in (1, 2, 26, 104)] == [3, 3, 15, 54]
