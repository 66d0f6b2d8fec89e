"""The port's banded-SW scoring stage against the JAX package.

 - banded_sw_scores_reference (the kernel's plain PyTorch version, which
   the wrapper runs for CPU tensors) is bit-equal to the Pallas kernel in
   interpret mode on the same padded inputs, and to the numpy DP
   align/core.py::banded_affine_dp;
 - TorchBatchAligner (deferred windows on that stage) gives alignments
   identical to the all-host path, synchronously and with the async
   finisher, CIGAR-capacity overflows included;
 - the MIN_DP_MAX gate keeps every deferred window, and the stage's scores
   equal the host DP's;
 - the CUDA kernel equals its plain version bit for bit (needs a GPU).
"""

import numpy as np
import pytest
import torch

from panmap_tpu.align.core import MIN_DP_MAX, banded_affine_dp
from panmap_tpu.align.pallas_sw import banded_sw_scores as pallas_sw_scores
from panmap_tpu.native import get_lib
from panmap_tpu_torch.align import sw
from panmap_tpu_torch.align.batch import TorchBatchAligner

from test_pallas_sw import _mutate_read, _random_case


def _batch(cases, LW=None):
    B = len(cases)
    LQ = max(len(q) for q, _ in cases)
    LW = LW or max(len(r) for _, r in cases)
    qb = np.full((B, LQ), 4, dtype=np.int8)
    rb = np.full((B, LW), 4, dtype=np.int8)
    ql = np.zeros(B, dtype=np.int32)
    for i, (q, r) in enumerate(cases):
        qb[i, : len(q)] = q
        rb[i, : len(r)] = r
        ql[i] = len(q)
    return qb, rb, ql


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("seed,lw", [(7, 360), (8, 300)])
def test_reference_matches_pallas_and_numpy_dp(seed, lw):
    rng = np.random.default_rng(seed)
    cases = [_random_case(rng, int(rng.integers(40, 151)), lw)
             for _ in range(16)]
    qb, rb, ql = _batch(cases)
    got = sw.banded_sw_scores(*_torch(qb, rb, ql))
    assert got.dtype == torch.int32 and got.shape == (16, 3)
    got = got.numpy()
    # the Pallas kernel pads LW to a multiple of 128 with code 4; padding
    # only adds columns, so compare it on the same padded windows
    LWp = -(-lw // 128) * 128
    qp, rp, _ = _batch(cases, LW=LWp)
    pallas = pallas_sw_scores(qp.astype(np.uint8), rp.astype(np.uint8), ql,
                              interpret=True)
    ref_padded = sw.banded_sw_scores_reference(*_torch(qp, rp, ql)).numpy()
    np.testing.assert_array_equal(ref_padded, pallas)
    for i, (q, r) in enumerate(cases):
        score, _, bi, _, bj, _ = banded_affine_dp(q, r)
        if score <= 0:
            assert got[i, 0] < MIN_DP_MAX
            continue
        assert tuple(got[i]) == (score, bi, bj), i


def test_reference_ragged_query_lengths():
    """qlens shorter than the padded LQ, zero-length queries, N codes."""
    rng = np.random.default_rng(5)
    B, LQ, LW = 24, 96, 200
    qb = rng.integers(0, 5, (B, LQ)).astype(np.int8)
    rb = rng.integers(0, 5, (B, LW)).astype(np.int8)
    ql = rng.integers(0, LQ + 1, B).astype(np.int32)
    ql[:2] = 0
    got = sw.banded_sw_scores(*_torch(qb, rb, ql)).numpy()
    assert np.all(got[:2] == 0)
    LQp, LWp = 128, 256
    qp = np.full((B, LQp), 4, np.uint8)
    rp = np.full((B, LWp), 4, np.uint8)
    qp[:, :LQ] = qb
    rp[:, :LW] = rb
    pallas = pallas_sw_scores(qp, rp, ql, interpret=True)
    ref_p = sw.banded_sw_scores_reference(
        *_torch(qp.astype(np.int8), rp.astype(np.int8), ql)).numpy()
    np.testing.assert_array_equal(ref_p, pallas)


def test_window_padding_upper_bounds():
    """Padding the window with code-4 columns never lowers the score (the
    gate in TorchBatchAligner relies on it)."""
    rng = np.random.default_rng(11)
    q, r = _random_case(rng, 120, 300)
    score, *_ = banded_affine_dp(q, r)
    for pad in (0, 57, 212):
        rb = np.full((1, len(r) + pad), 4, dtype=np.int8)
        rb[0, : len(r)] = r
        out = sw.banded_sw_scores(*_torch(q[None, :].astype(np.int8), rb,
                                          np.array([len(q)], np.int32)))
        assert int(out[0, 0]) >= score


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((4, 10), dtype=torch.int8)
    r = torch.zeros((4, 20), dtype=torch.int8)
    ql = torch.full((4,), 10, dtype=torch.int32)
    with pytest.raises(TypeError):
        sw.banded_sw_scores(q.to(torch.int32), r, ql)
    with pytest.raises(TypeError):
        sw.banded_sw_scores(q, r, ql.long())
    with pytest.raises(ValueError):
        sw.banded_sw_scores(q, r[:3], ql)
    with pytest.raises(ValueError):
        sw.banded_sw_scores(q, torch.zeros((4, sw.MAX_LW + 1),
                                           dtype=torch.int8), ql)
    with pytest.raises(ValueError):
        sw.banded_sw_scores(q.t().contiguous().t(), r, ql)
    with pytest.raises(ValueError):
        sw.banded_sw_scores(q.to("meta"), r.to("meta"), ql.to("meta"))
    before = sw.LAUNCHES
    sw.banded_sw_scores(q, r, ql)  # CPU: the plain version, no launch
    assert sw.LAUNCHES == before


def _reads(seed, n):
    rng = np.random.default_rng(seed)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    reads = [_mutate_read(rng, ref, int(rng.integers(0, len(ref) - 180)), 151)
             for _ in range(n)]
    return ref, reads


@pytest.mark.parametrize("deferred_async", [False, True])
def test_aligner_arrays_device_stage_identical(deferred_async):
    """TorchBatchAligner's arrays equal the all-host path field for field,
    with the SW stage actually scoring the deferred rows."""
    from panmap_tpu.align.batch import BatchAligner

    if get_lib() is None:
        pytest.skip("native library unavailable")
    ref, reads = _reads(31, 60)
    host = BatchAligner(ref)
    host.pallas_mode = None
    base = host.align_batch_arrays(reads)
    dev = TorchBatchAligner(ref, "cpu")
    got = dev.align_batch_arrays(reads, deferred_async=deferred_async)
    fin = got.pop("_fin", None)
    if deferred_async:
        assert fin is not None and (got["mapped"] == 3).sum() > 0
        fin()
    assert (got["mapped"] == 3).sum() == 0
    st = dev.pallas_stats
    assert st["deferred"] > 0 and st["device_scored"] == st["deferred"]
    _assert_same_arrays(base, got)


def _assert_same_arrays(base, got):
    for key in ("mapped", "rev", "rs", "re", "qs", "qe", "score", "mapq",
                "nm", "ncig"):
        np.testing.assert_array_equal(base[key], got[key], err_msg=key)
    np.testing.assert_array_equal(base["cig"], got["cig"])
    assert base["extra_cigars"] == got["extra_cigars"]


@pytest.mark.parametrize("deferred_async", [False, True])
def test_aligner_cigar_overflow_oracle_identical(monkeypatch, deferred_async):
    """Reads whose CIGAR overflows the native capacity (mapped == 2) are
    redone by BatchAligner's numpy oracle, which the port runs with its own
    read encoder; arrays and oversized CIGARs equal the all-host path's."""
    import functools

    import panmap_tpu.native as native
    import panmap_tpu_torch.native as port_native
    from panmap_tpu.align.batch import BatchAligner

    if get_lib() is None:
        pytest.skip("native library unavailable")
    # a 2-op capacity makes every read with an indel overflow, in each
    # package's own native library
    for mod in (native, port_native):
        monkeypatch.setattr(mod, "align_sr_native", functools.partial(
            mod.align_sr_native, cigar_cap=2))
    ref, reads = _reads(41, 60)
    host = BatchAligner(ref)
    host.pallas_mode = None
    base = host.align_batch_arrays(reads)
    assert len(base["extra_cigars"]) > 10
    dev = TorchBatchAligner(ref, "cpu")
    got = dev.align_batch_arrays(reads, deferred_async=deferred_async)
    fin = got.pop("_fin", None)
    if fin is not None:
        fin()
    assert dev.pallas_stats["device_scored"] > 0
    _assert_same_arrays(base, got)


def test_gate_keeps_every_seeded_window(monkeypatch):
    """Every deferred window holds an exact k-mer seed of its read (k = 21),
    so it scores at least 2k = 42 > MIN_DP_MAX: the gate drops no window,
    even of chimeric reads, and each kernel triple equals the host DP's
    (score, query end, window end) for that window."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)

    def junk(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    ref = junk(30000)
    reads = []
    for _ in range(400):
        p = int(rng.integers(0, 29800))
        # two 30 bp pieces of the genome 70 bp apart, in random filler
        reads.append(junk(15) + ref[p:p + 30] + junk(30) + ref[p + 70:p + 100]
                     + junk(45))
    outs = []
    real = sw.banded_sw_scores
    monkeypatch.setattr(sw, "banded_sw_scores",
                        lambda *a: outs.append(real(*a)) or outs[-1])
    dev = TorchBatchAligner(ref, "cpu")
    res = dev.align_batch_arrays(reads, deferred_async=True)
    rows = np.flatnonzero(res["mapped"] == 3)
    lo = res["rs"][rows].copy()
    res.pop("_fin")()
    st = dev.pallas_stats
    assert st["device_scored"] == len(rows) > 50
    assert st["survivors"] == st["device_scored"]
    (out,) = (o.numpy() for o in outs)
    assert out[:, 0].min() >= 2 * 21 > MIN_DP_MAX
    assert np.all(res["mapped"][rows] == 1)
    np.testing.assert_array_equal(out[:, 0], res["score"][rows])
    np.testing.assert_array_equal(out[:, 1], res["qe"][rows])
    np.testing.assert_array_equal(out[:, 2], res["re"][rows] - lo)


@pytest.mark.gpu
def test_cuda_kernel_matches_reference():
    """The CUDA kernel equals its plain version bit for bit on the card
    (LW from 1 column to the 2048 maximum, ragged query lengths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    for B, LQ, LW in [(7, 150, 1), (9, 150, 37), (300, 512, 2048),
                      (1024, 160, 421)]:
        q = rng.integers(0, 5, (B, LQ)).astype(np.int8)
        r = rng.integers(0, 5, (B, LW)).astype(np.int8)
        ql = rng.integers(0, LQ + 1, B).astype(np.int32)
        qt, rt, lt = (torch.from_numpy(x).cuda() for x in (q, r, ql))
        before = sw.LAUNCHES
        got = sw.banded_sw_scores(qt, rt, lt)
        assert sw.LAUNCHES == before + 1
        torch.testing.assert_close(got, sw.banded_sw_scores_reference(
            qt, rt, lt), rtol=0, atol=0)
