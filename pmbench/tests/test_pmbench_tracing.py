"""The traced window's reduction: device busy and idle time from the union
of the profiler's device intervals (never a subtraction of stage times),
idle gaps named by the host span open over them, and the readers of the
per-layer metrics on a synthetic trace."""

import pytest

from pmbench import manifest, roofline, tracing


def synthetic():
    spans = tracing.Spans(sync=lambda: None)
    spans.items = [("sample", 0.0, 10.0), ("place", 1.0, 3.0),
                   ("genotype", 5.0, 9.0), ("sample", 10.0, 20.0),
                   ("place", 11.0, 13.0), ("genotype", 15.0, 19.0)]
    ops = [("kernel_a", 1.0, 1.5), ("kernel_b", 1.25, 2.0),  # overlapping
           ("(anonymous namespace)::banded_sw_kernel(x)", 4.0, 4.001),
           ("Memcpy HtoD", 11.0, 11.5), ("kernel_a", 12.0, 12.25),
           ("(anonymous namespace)::banded_sw_kernel(x)", 14.0, 14.001)]
    busy = tracing.union([(a, b) for _, a, b in ops])
    t = tracing.Trace(n_samples=2, window_s=20.0, spans=spans,
                      device_ops=ops,
                      launches={"banded_sw": [(2500, 150, 379)] * 2},
                      busy_s=sum(b - a for a, b in busy),
                      idle=tracing.gaps(busy, 0.0, 20.0))
    t.idle_by_span = tracing.label_gaps(t.idle, spans.items)
    return t


def test_union_and_gaps():
    assert tracing.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert tracing.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    t = synthetic()
    assert t.busy_s == pytest.approx(1.0 + 0.001 + 0.5 + 0.25 + 0.001)


def test_idle_share_and_kernel_time():
    t = synthetic()
    idle = manifest.reader("device.idle_pct")(t)
    assert idle == pytest.approx(100 * (20 - 1.752) / 20)
    # kernels only, copies left out, per sample
    assert manifest.reader("device.kernel_ms")(t) == pytest.approx(
        1e3 * (0.5 + 0.75 + 0.001 + 0.25 + 0.001) / 2)


def test_idle_gaps_named_by_the_open_span():
    t = synthetic()
    named = dict(t.idle_by_span)
    assert sum(named.values()) == pytest.approx(20 - t.busy_s)
    assert named["place"] == pytest.approx(2.0 + 2.0 - 1.0 - 0.75)
    assert named["genotype"] == pytest.approx(8.0)
    assert "harness" not in named


def test_span_metrics_per_sample():
    t = synthetic()
    assert manifest.reader("place.s")(t) == pytest.approx(2.0)
    assert manifest.reader("genotype.s")(t) == pytest.approx(4.0)
    assert manifest.reader("align.s")(t) is None


def test_sw_roofline():
    t = synthetic()
    want = 100 * 2 * roofline.sw_bound_s(2500, 150, 379) / 0.002
    assert manifest.reader("sw.roofline_pct")(t) == pytest.approx(want)
    assert roofline.sw_bound_s(2500, 150, 379) == pytest.approx(
        2500 * 150 * 379 * 20 / 16.75e12)
    t.launches["banded_sw"].append((10, 150, 379))  # a launch not traced
    assert manifest.reader("sw.roofline_pct")(t) is None


def test_nothing_to_read():
    t = tracing.Trace(n_samples=1, window_s=5.0,
                      spans=tracing.Spans(lambda: None), busy_s=0.0)
    for name in ("device.idle_pct", "device.kernel_ms", "sw.roofline_pct",
                 "meta.em_s"):
        assert manifest.reader(name)(t) is None
