"""The port's long-read DP stage against the JAX package.

 - long_dp_rows_reference (the kernel's plain PyTorch version, which the
   wrapper runs for CPU tensors) is bit-equal to the Pallas kernel in
   interpret mode on every in-band cell and row, for both presets;
 - long_dp_batch equals the host DP banded_dp_shifted and the Pallas
   batch entry long_dp_device_batch item by item, narrow bands included, and
   routes oversized items to the host DP, counted;
 - the port's _finish_one is the JAX package's, line for line;
 - TorchLongReadAligner equals LongReadAligner field for field;
 - the CUDA kernel equals its plain version bit for bit (needs a GPU).

Tolerance everywhere: exact equality (the path is all integer).
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from panmap_tpu.align import longread as jax_longread
from panmap_tpu.align import pallas_long
from panmap_tpu.align.core import encode
from panmap_tpu.align.longread import LongReadAligner, banded_dp_shifted
from panmap_tpu_torch.align import long_dp
from panmap_tpu_torch.align import longread as port_longread
from panmap_tpu_torch.align.longread import (
    MAP_HIFI,
    MAP_ONT,
    TorchLongReadAligner,
)

# the port's presets; the JAX package's functions get its own class
PRESETS = [MAP_ONT, MAP_HIFI]


def _jax(pre):
    """The port's LongPreset as the JAX package's (field for field)."""
    assert isinstance(pre, port_longread.LongPreset)
    return jax_longread.LongPreset(**asdict(pre))


def test_presets_are_the_jax_packages():
    for mine, theirs in ((MAP_ONT, jax_longread.MAP_ONT),
                         (MAP_HIFI, jax_longread.MAP_HIFI)):
        assert asdict(mine) == asdict(theirs)
        assert _jax(mine) == theirs
    for n in (400, 4999, 5000, 20000):
        assert (port_longread.pick_preset(n).name
                == jax_longread.pick_preset(n).name)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions' row loops run thousands of small ops, which
    intra-op threads only slow down when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(s: str) -> np.ndarray:
    return encode(np.frombuffer(s.encode(), np.uint8))


def _items(seed, n, len_lo, len_hi, margin):
    """(reference codes, [(q, dlo, dhi)]) with substitutions everywhere and,
    in turn, a long deletion (the E2 tier), an insertion, and a random
    second half (a z-drop stop); bands reach ``margin`` either side."""
    rng = np.random.default_rng(seed)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 8000))
    items = []
    for t in range(n):
        L = int(rng.integers(len_lo, len_hi))
        p = int(rng.integers(margin, len(ref) - L - 2 * margin))
        frag = list(ref[p:p + L])
        for j in range(L):
            if rng.random() < 0.05:
                frag[j] = "ACGT"[("ACGT".find(frag[j]) + 1) % 4]
        if t % 4 == 1:  # long deletion
            d = int(rng.integers(80, min(300, margin)))
            frag = frag[: L // 2] + list(ref[p + L // 2 + d: p + L + d])
        elif t % 4 == 2:  # insertion
            frag = (frag[: L // 3]
                    + ["ACGT"[int(rng.integers(4))]
                       for _ in range(int(rng.integers(20, 60)))]
                    + frag[L // 3:])
        elif t % 4 == 3:  # unrelated second half: z-drop
            frag = frag[: L // 2] + ["ACGT"[int(c)]
                                     for c in rng.integers(0, 4, L - L // 2)]
        items.append((_codes("".join(frag)), p - margin, p + margin))
    return _codes(ref), items


def _torch_inputs(items):
    B = len(items)
    LQ = max(len(q) for q, _, _ in items)
    W = max(dhi - dlo + 1 for _, dlo, dhi in items)
    qb = np.full((B, LQ), 4, np.int8)
    meta = np.zeros((B, 3), np.int32)
    for s, (q, dlo, dhi) in enumerate(items):
        qb[s, : len(q)] = q
        meta[s] = (len(q), dlo, dhi - dlo + 1)
    return torch.from_numpy(qb), torch.from_numpy(meta), W


def _pallas_rows(items, refc, pre):
    """dirs and stats of the Pallas kernel in interpret mode, its inputs
    padded as long_dp_device_batch pads them."""
    import jax.numpy as jnp

    TB = pallas_long.TILE_B
    B = -(-len(items) // TB) * TB
    W = pallas_long._round_up(max(b - a + 1 for _, a, b in items), 128)
    LQ = pallas_long._round_up(max(len(q) for q, _, _ in items), 512)
    qb = np.full((B, LQ), 4, np.uint8)
    rb = np.full((B, LQ, W), 4, np.uint8)
    meta = np.zeros((B, 128), np.int32)
    for s, (q, dlo, dhi) in enumerate(items):
        qb[s, : len(q)] = q
        rb[s, : len(q)] = pallas_long._build_band(refc, len(q), dlo, W)
        meta[s, :3] = (dlo, len(refc), dhi - dlo + 1)
    pre = _jax(pre)
    dirs, stats = pallas_long._long_call(
        jnp.asarray(qb.astype(np.int8)), jnp.asarray(rb.astype(np.int8)),
        jnp.asarray(meta), pre.match, pre.mismatch, pre.gap_open,
        pre.gap_ext, pre.gap_open2, pre.gap_ext2, True)
    return np.asarray(dirs), np.asarray(stats)


@pytest.mark.parametrize("pre", PRESETS, ids=lambda p: p.name)
def test_reference_matches_pallas_kernel(pre):
    refc, items = _items(3, 8, 300, 480, 200)
    q, meta, W = _torch_inputs(items)
    dirs, stats = long_dp.long_dp_rows(q, torch.from_numpy(
        refc.astype(np.int8)), meta, pre, W)
    assert dirs.dtype == torch.int8 and stats.dtype == torch.int32
    assert dirs.shape == (len(items), q.shape[1], W)
    assert stats.shape == (len(items), q.shape[1], 2)
    dirs, stats = dirs.numpy(), stats.numpy()
    pdirs, pstats = _pallas_rows(items, refc, pre)
    for s, (qq, dlo, dhi) in enumerate(items):
        lq, wo = len(qq), dhi - dlo + 1
        np.testing.assert_array_equal(dirs[s, :lq, :wo], pdirs[s, :lq, :wo],
                                      err_msg=f"dirs of item {s}")
        np.testing.assert_array_equal(stats[s, :lq], pstats[s, :lq, :2],
                                      err_msg=f"stats of item {s}")
        # padded cells hold the one defined value
        assert not dirs[s, lq:].any() and not dirs[s, :, wo:].any()
        assert not stats[s, lq:].any()
    # the cases reach every direction source and flag
    srcs = set(np.unique(dirs & 7).tolist())
    assert srcs >= {0, 1, 2, 4}, srcs
    assert all((dirs >> bit & 1).any() for bit in (3, 5))


def _zdrop_row(stats, lq, pre):
    """The row at which _finish_one's z-drop replay stops (None: it runs to
    the end of the query)."""
    best = (0, 0, 0)
    for i in range(1, lq + 1):
        row_max, cmax = int(stats[i - 1, 0]), int(stats[i - 1, 1])
        if row_max > best[0]:
            best = (row_max, i, cmax)
        elif best[0] - row_max > pre.zdrop + pre.gap_ext * abs(cmax - best[2]):
            return i
    return None


# a lower z-drop makes the random-tail items stop within a test's read
# length (under the presets' 400 they need ~800 random rows); the kernel
# does not read zdrop, the host replay does
ZDROP_100 = replace(MAP_ONT, name="map-ont-zdrop100", zdrop=100)


@pytest.mark.parametrize("pre", PRESETS + [ZDROP_100], ids=lambda p: p.name)
def test_batch_matches_host_dp_and_pallas_batch(pre):
    refc, items = _items(11, 6, 500, 900, 300)
    stats = {}
    got = long_dp.long_dp_batch(items, refc, pre, "cpu", stats)
    host = [banded_dp_shifted(q, refc, a, b, _jax(pre)) for q, a, b in items]
    assert got == host
    assert got == [port_longread.banded_dp_shifted(q, refc, a, b, pre)
                   for q, a, b in items]
    assert got == pallas_long.long_dp_device_batch(items, refc, _jax(pre),
                                                   interpret=True)
    assert (stats["items"], stats["device_dp"], stats["host_dp"]) == (6, 6, 0)
    if pre is not MAP_HIFI:  # the deletion item aligns across it
        assert any(n >= 80 and op == "D" for n, op in got[1][5])
    if pre is ZDROP_100:  # the random-tail item stops on z-drop
        q, meta, W = _torch_inputs(items[3:4])
        _, rows = long_dp.long_dp_rows(q, torch.from_numpy(
            refc.astype(np.int8)), meta, pre, W)
        assert _zdrop_row(rows[0].numpy(), len(items[3][0]), pre)


def test_batch_narrow_bands_and_edges():
    """The narrow-band cases of test_long_device_dp_narrow_band_padding_masked
    and bands that start before the reference or run past its end."""
    rng = np.random.default_rng(5)
    refc = _codes("".join("ACGT"[i] for i in rng.integers(0, 4, 6000)))
    q = refc[3000:3800].copy()
    cases = [(q, 2800, 2928), (q, 3000 - 64, 3000 + 64),
             (refc[100:900].copy(), 40, 168),
             (refc[20:700].copy(), -180, 220),
             (refc[5400:6000].copy(), 5300, 5700)]
    got = long_dp.long_dp_batch(cases, refc, MAP_ONT, "cpu")
    assert got == [banded_dp_shifted(qq, refc, a, b, _jax(MAP_ONT))
                   for qq, a, b in cases]
    assert got == pallas_long.long_dp_device_batch(cases, refc, _jax(MAP_ONT),
                                                   interpret=True)


@pytest.mark.parametrize("cap", ["MAX_ITEM_CELLS", "MAX_W"])
def test_oversized_items_run_the_host_dp(monkeypatch, cap):
    refc, items = _items(17, 3, 400, 600, 250)
    want = long_dp.long_dp_batch(items, refc, MAP_ONT, "cpu")
    # item 0 padded: 512 x 512 cells, W 501 (the others alike)
    monkeypatch.setattr(long_dp, cap, 512 * 512 - 1 if cap == "MAX_ITEM_CELLS"
                        else 500)
    stats = {}
    got = long_dp.long_dp_batch(items, refc, MAP_ONT, "cpu", stats)
    assert got == want
    assert (stats["items"], stats["device_dp"], stats["host_dp"]) == (3, 0, 3)


def test_batch_chunks_under_the_dirs_cap(monkeypatch):
    """Launches stay under DIRS_CAP direction bytes; results are unchanged."""
    refc, items = _items(23, 5, 300, 400, 150)
    want = long_dp.long_dp_batch(items, refc, MAP_ONT, "cpu")
    shapes = []
    real = long_dp.long_dp_rows

    def spy(q, ref, meta, pre, width):
        shapes.append((q.shape[0], q.shape[1], width))
        return real(q, ref, meta, pre, width)

    monkeypatch.setattr(long_dp, "long_dp_rows", spy)
    monkeypatch.setattr(long_dp, "DIRS_CAP", 2 * 400 * 301)
    assert long_dp.long_dp_batch(items, refc, MAP_ONT, "cpu") == want
    assert len(shapes) >= 3 and sum(s[0] for s in shapes) == 5
    assert all(b * lq * w <= 2 * 400 * 301 for b, lq, w in shapes)


@pytest.mark.parametrize("margin", [107, 131, 164], ids=lambda m: f"W{2*m+1}")
def test_batch_rounds_the_launch_width_to_16(monkeypatch, margin):
    """long_dp_batch launches at W rounded up to a multiple of 16 (the
    kernel's 8-byte stores want aligned rows); the padded columns are 0 and
    are cut off again, so the results equal banded_dp_shifted item by item
    for bands whose width is no multiple of 16."""
    refc, items = _items(37, 5, 200, 330, margin)
    # bands of different widths in one launch, none a multiple of 16
    items = [(q, dlo + s, dhi) for s, (q, dlo, dhi) in enumerate(items)]
    assert all((dhi - dlo + 1) % 16 for _, dlo, dhi in items)
    widths = []
    real = long_dp.long_dp_rows

    def spy(q, ref, meta, pre, width):
        widths.append((int(meta[:, 2].max()), width))
        dirs, rows = real(q, ref, meta, pre, width)
        for s in range(q.shape[0]):
            assert not dirs[s, :, int(meta[s, 2]):].any()
        return dirs, rows

    monkeypatch.setattr(long_dp, "long_dp_rows", spy)
    got = long_dp.long_dp_batch(items, refc, MAP_ONT, "cpu")
    assert got == [banded_dp_shifted(q, refc, a, b, _jax(MAP_ONT))
                   for q, a, b in items]
    assert widths and all(w % 16 == 0 and 0 <= w - worig < 16
                          for worig, w in widths)


def test_items_past_the_packed_row_max_run_the_host_dp():
    """The kernel packs a row's (max, argmax) as (h << 14) | (16383 - c),
    so it takes match * LQ < 2^17, and the wrapper refuses a longer launch.
    No preset's item gets there: at the narrowest band (2 * bw + 1) the
    cell cap already sends a query of MAX_PACKED_H / match bases to the
    host DP."""
    for pre in PRESETS:
        w = 2 * pre.bw
        q = np.zeros(long_dp.MAX_PACKED_H // pre.match, np.uint8)
        assert long_dp._on_host(q, 0, w)
        assert not long_dp._on_host(q[:1400], 0, w)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(torch.zeros((1, 1 << 16), dtype=torch.int8),
                             torch.zeros(50, dtype=torch.int8),
                             torch.tensor([[4, 0, 8]], dtype=torch.int32),
                             MAP_ONT, 8)


def test_finish_one_is_the_jax_packages():
    ours, theirs = long_dp._finish_one, pallas_long._finish_one
    for attr in ("co_code", "co_consts", "co_names", "co_varnames"):
        assert getattr(ours.__code__, attr) == getattr(theirs.__code__, attr)
    refc, items = _items(29, 4, 300, 400, 150)
    q, meta, W = _torch_inputs(items)
    dirs, stats = long_dp.long_dp_rows(q, torch.from_numpy(
        refc.astype(np.int8)), meta, MAP_ONT, W)
    for s, (qq, dlo, dhi) in enumerate(items):
        d, st = dirs[s].numpy(), stats[s].numpy()
        assert ours(qq, dlo, d, st, MAP_ONT) == theirs(qq, dlo, d, st,
                                                       _jax(MAP_ONT))


def _mixed_reads(seed, n):
    """The read set of test_long_aligner_device_batch_matches_host: errors,
    deletions, reverse strands, and a junk read."""
    rng = np.random.default_rng(seed)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 16000))
    reads = []
    for t in range(n):
        L = int(rng.integers(700, 3000))
        p = int(rng.integers(0, len(ref) - L - 400))
        frag = list(ref[p:p + L])
        for j in range(L):
            if rng.random() < 0.06:
                frag[j] = "ACGT"[(("ACGT".find(frag[j])) + 1) % 4]
        if t % 4 == 1:
            d = int(rng.integers(50, 200))
            frag = frag[: L // 2] + list(ref[p + L // 2 + d: p + L + d])
        s = "".join(frag)
        if t % 2:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append(s)
    reads.append("ACGT" * 10)  # unmapped short junk
    return ref, reads


@pytest.mark.parametrize("pre", PRESETS, ids=lambda p: p.name)
def test_aligner_matches_host_aligner(pre):
    ref, reads = _mixed_reads(71, 12)
    base = LongReadAligner(ref, _jax(pre)).align_batch(reads, device=None)
    host = port_longread.LongReadAligner(ref, pre).align_batch(reads)
    stats = {}
    got = TorchLongReadAligner(ref, pre, "cpu", stats=stats).align_batch(
        reads)
    assert len(got) == len(base) == len(host)
    for i, (a, b, c) in enumerate(zip(base, got, host)):
        assert (a.mapped, a.rev, a.rs, a.re, a.qs, a.qe, a.score, a.mapq,
                a.cigar) == (b.mapped, b.rev, b.rs, b.re, b.qs, b.qe,
                             b.score, b.mapq, b.cigar), i
        assert (a.mapped, a.rs, a.re, a.score, a.cigar) == (
            c.mapped, c.rs, c.re, c.score, c.cigar), i
    assert not got[-1].mapped
    assert sum(a.mapped and a.rev for a in got) > 0
    assert stats["device_dp"] == stats["items"] > 0 and stats["host_dp"] == 0


def test_wrapper_rejects_bad_inputs():
    q = torch.full((2, 10), 4, dtype=torch.int8)
    ref = torch.zeros(50, dtype=torch.int8)
    meta = torch.tensor([[10, 0, 8], [5, 3, 8]], dtype=torch.int32)
    with pytest.raises(TypeError):
        long_dp.long_dp_rows(q.to(torch.int32), ref, meta, MAP_ONT, 8)
    with pytest.raises(TypeError):
        long_dp.long_dp_rows(q, ref.to(torch.uint8), meta, MAP_ONT, 8)
    with pytest.raises(TypeError):
        long_dp.long_dp_rows(q, ref, meta.long(), MAP_ONT, 8)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q, ref, meta[:1], MAP_ONT, 8)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q, ref, meta[:, :2].contiguous(), MAP_ONT, 8)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q, ref[None], meta, MAP_ONT, 8)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q.t().contiguous().t(), ref, meta, MAP_ONT, 8)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q, ref, meta, MAP_ONT, long_dp.MAX_W + 1)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q, ref, meta, MAP_ONT, 0)
    with pytest.raises(ValueError):
        long_dp.long_dp_rows(q.to("meta"), ref.to("meta"), meta.to("meta"),
                             MAP_ONT, 8)
    before = long_dp.LAUNCHES
    long_dp.long_dp_rows(q, ref, meta, MAP_ONT, 8)  # CPU: no launch
    assert long_dp.LAUNCHES == before


@pytest.mark.gpu
def test_cuda_kernel_matches_reference():
    """The CUDA kernel equals its plain version bit for bit on the card:
    both presets, narrow and multi-chunk bands (W 1 to 2,600), bands off
    either end of the reference, ragged query lengths, padded cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.integers(0, 5, 5000).astype(np.int8)).cuda()
    for pre in PRESETS:
        for B, LQ, W in [(3, 40, 1), (5, 300, 33), (16, 700, 1100),
                         (4, 200, 2600)]:
            q = torch.from_numpy(rng.integers(0, 5, (B, LQ)).astype(np.int8))
            meta = np.stack([rng.integers(0, LQ + 1, B),
                             rng.integers(-300, 5000, B),
                             rng.integers(1, W + 1, B)], 1).astype(np.int32)
            meta[0] = (LQ, 100, W)
            qt, mt = q.cuda(), torch.from_numpy(meta).cuda()
            before = long_dp.LAUNCHES
            got = long_dp.long_dp_rows(qt, ref, mt, pre, W)
            assert long_dp.LAUNCHES == before + 1
            want = long_dp.long_dp_rows_reference(qt, ref, mt, pre, W)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_kernel_edge_items():
    """The redesigned kernel on the edge launches of chip_smoke.py's phase
    7 (chip_smoke.long_edge_phase: both presets, both column counts per
    thread the kernel chooses between); bit-equal over whole arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    n, err = chip_smoke.long_edge_phase(long_dp, np.random.default_rng(4),
                                        torch.device("cuda", 0))
    assert n >= 26 and err == 0
