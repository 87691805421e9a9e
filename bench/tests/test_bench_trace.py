"""The reduction of a device trace, and the metrics read from one, on
records made up here (the trace itself needs the card)."""
from bench.harness import registry
from bench.harness.trace import SHORT, UNPROBED, idle_gaps, label_gaps, merge


def test_busy_intervals_merge_and_gaps_are_the_rest():
    busy = merge([(5, 8), (0, 2), (1, 3), (7, 9)])
    assert busy == [(0, 3), (5, 9)]
    assert idle_gaps(busy, 0, 12) == [(3, 5), (9, 12)]
    assert idle_gaps(busy, 1, 6) == [(3, 5)]


def test_gaps_are_named_by_the_host_span_over_them():
    ms = 1_000_000
    gaps = [(0, 5 * ms), (10 * ms, 10 * ms + 1000), (20 * ms, 30 * ms)]
    spans = [("tree.fork", -ms, 4 * ms), ("engine.step", 3 * ms, 9 * ms),
             ("engine.step", 21 * ms, 22 * ms), ("tree.fork", 22 * ms, 40 * ms)]
    out = label_gaps(gaps, spans)
    assert out["tree.fork"][1] == 2 and abs(out["tree.fork"][0] - 0.015) < 1e-12   # whole gaps
    assert out[SHORT][1] == 1
    assert UNPROBED not in out
    assert label_gaps([(0, ms)], [])[UNPROBED][1] == 1


def test_roofline_and_idle_from_a_trace():
    rec = {
        "trace": {"busy_s": 1.0, "window_s": 4.0, "span_ns": (100, 200),
                  "by_name": {"void repro::paged_attention_mma_kernel<128>": 0.002,
                              "nvjet_gemm": 0.5}},
        "spans": [("engine.step", 110, 150, 0, ([8193, 8193], 8193)),
                  ("engine.step", 90, 150, 0, ([8193], 8193)),       # before the trace
                  ("tree.fork", 120, 130, 0, None)],
        "costs": {"pa_bytes_per_position": 1000.0, "pa_bytes_per_row": 10.0},
    }
    roofline = registry.load_module("metrics", "kernel.paged_attention_roofline").read(rec)
    want = 100.0 * (8193 * 1000.0 + 2 * 10.0) / 3.35e12 / 0.002
    assert abs(roofline - want) < 1e-9
    assert registry.load_module("metrics", "device.idle").read(rec) == 75.0
    rec["trace"] = None
    assert registry.load_module("metrics", "device.idle").read(rec) is None
