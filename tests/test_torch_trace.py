"""The span tracer and the metrics registry (``repro_torch.obs``) against
the JAX reference's (``repro.obs``), after ``tests/test_obs.py``.

The Chrome trace of one span sequence must have the reference's event
names, phases, args and nesting (times differ, so they are compared only
as containment); the registry must aggregate as the reference's does.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.obs import MetricsRegistry as JaxRegistry  # noqa: E402
from repro.obs import SpanTracer as JaxTracer  # noqa: E402
from repro.obs.trace import traced as jax_traced  # noqa: E402
from repro.staticcheck.jaxpr_audit import count_compile_signatures  # noqa: E402
from repro_torch.core import build_bvh, query_count, query_csr_device, within  # noqa: E402
from repro_torch.core.fdbscan_grid import GridAutoInfo  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.core.query import BufferedCsr  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Span, SpanTracer,  # noqa: E402
                             load_chrome_trace, span_tree, traced)
from repro_torch.obs.metrics import count_signatures  # noqa: E402
from repro_torch.obs.trace import block_until_ready  # noqa: E402


def _brute_counts(pts, eps):
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    return (d2 <= eps * eps).sum(1)


def _sequence(tracer, traced_fn, value):
    """One span sequence: nesting, a fence, a traced call, an instant, a
    counter."""
    with tracer.span("outer", n=4) as sp:
        with tracer.span("inner", k="a"):
            time.sleep(0.002)
        sp.fence(value)
        traced_fn(tracer, "call", lambda x: x, value, span_args={"k": 1})
    tracer.instant("marker", step=1)
    tracer.counter("hits", total=3, overflowed=0)


def test_tracer_nesting_and_roundtrip(tmp_path):
    tracer = SpanTracer(process_name="test")
    with tracer.span("outer", n=4) as sp:
        assert isinstance(sp, Span)
        with tracer.span("inner"):
            time.sleep(0.002)
        val = sp.fence(torch.arange(8).sum())
    assert int(val) == 28
    tracer.instant("marker", step=1)
    tracer.counter("hits", total=3)

    path = tracer.export(str(tmp_path / "trace.json"))
    events = load_chrome_trace(path)
    assert [e["name"] for e in events] == ["outer", "inner"]
    assert span_tree(events)["outer"] == ["inner"]
    outer, inner = events
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["args"] == {"n": 4, "depth": 0}
    with open(path) as f:
        raw = json.load(f)["traceEvents"]
    assert {e["ph"] for e in raw} == {"M", "X", "i", "C"}


def test_chrome_trace_matches_reference(tmp_path):
    """The same span sequence through both tracers: the same events in the
    same order (names, phases, categories, args), the same metadata and
    the same nesting."""
    jt, tt = JaxTracer(process_name="p"), SpanTracer(process_name="p")
    _sequence(jt, jax_traced, jnp.arange(4))
    _sequence(tt, traced, torch.arange(4))

    def strip(doc):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
                for e in doc["traceEvents"]]

    assert strip(tt.to_chrome()) == strip(jt.to_chrome())
    assert tt.to_chrome()["displayTimeUnit"] == jt.to_chrome()["displayTimeUnit"]
    ev_t = load_chrome_trace(tt.export(str(tmp_path / "t.json")))
    ev_j = load_chrome_trace(jt.export(str(tmp_path / "j.json")))
    assert span_tree(ev_t) == span_tree(ev_j) == {
        "outer": ["inner", "call"], "inner": [], "call": []}


def test_traced_none_is_passthrough():
    calls = []

    def fn(x, y=1):
        calls.append((x, y))
        return x + y

    assert traced(None, "noop", fn, 2, y=3) == 5
    tracer = SpanTracer()
    assert traced(tracer, "yes", fn, 2, y=3, span_args={"k": 1}) == 5
    assert calls == [(2, 3), (2, 3)]
    assert tracer.events[0]["name"] == "yes"
    assert tracer.events[0]["args"]["k"] == 1


def test_tracer_exception_unwind(monkeypatch):
    """A span left by an exception still closes (no dangling stack) and
    skips its fences."""
    fenced = []
    monkeypatch.setattr("repro_torch.obs.trace.block_until_ready",
                        fenced.append)
    tracer = SpanTracer()
    with pytest.raises(RuntimeError):
        with tracer.span("outer") as sp:
            sp.fence(torch.ones(2))
            with tracer.span("boom"):
                raise RuntimeError("x")
    assert [e["name"] for e in tracer.events] == ["boom", "outer"]
    assert tracer._stack == []
    assert fenced == []
    with tracer.span("ok") as sp:
        sp.fence(torch.ones(2))
    assert len(fenced) == 1


def test_fence_walks_nested_values(monkeypatch):
    """``block_until_ready`` finds the tensors in tuples, NamedTuples,
    lists and dicts and synchronizes each CUDA device once; CPU tensors
    and other leaves need nothing."""
    synced = []

    class FakeStream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            synced.append(self.dev)

    class FakeCuda:
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    monkeypatch.setattr(torch, "Tensor", (torch.Tensor, FakeCuda))
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    csr = BufferedCsr(torch.zeros(3), FakeCuda(0), 1, False)
    block_until_ready({"a": [csr, (FakeCuda(0), FakeCuda(1))], "b": 3,
                       "c": torch.ones(2)})
    assert sorted(d.index for d in synced) == [0, 1]


def test_registry_aggregates_scalars_and_arrays():
    for reg, vec in ((MetricsRegistry(), torch.tensor([2.0, 3.0])),
                     (JaxRegistry(), jnp.asarray([2.0, 3.0]))):
        reg.record("x", 1)
        reg.record("x", vec)
        reg.record("x", np.float32(4.0))
        assert reg.summary()["x"] == {"records": 3, "count": 4, "sum": 10.0,
                                      "min": 1.0, "max": 4.0, "last": 4.0}


def test_registry_observe_known_types(tmp_path):
    """``DeviceCsr``, ``TraversalStats``, ``BufferedCsr`` and
    ``GridAutoInfo`` explode into the reference's series."""
    pts = make_clustered_points(np.random.default_rng(2), 64)
    tp = torch.from_numpy(pts)
    bvh = build_bvh(tp, *scene_bounds(tp))
    csr = query_csr_device(bvh, within(tp, 0.2), capacity=4096)
    _, stats = query_count(bvh, within(tp, 0.2), with_stats=True)

    reg = MetricsRegistry()
    reg.observe("csr", csr)
    reg.observe("q", stats)
    reg.observe("buf", BufferedCsr(torch.tensor([0, 4, 9]), torch.zeros(9), 2,
                                   True))
    reg.observe("grid", GridAutoInfo(attempts=3, capacity=16, overflowed=True))
    reg.observe("other", torch.tensor([7]))
    s = reg.summary()
    total = float(_brute_counts(pts, 0.2).sum())
    assert s["csr/total"]["last"] == total
    assert s["csr/overflowed"]["last"] == 0.0
    assert s["q/callback_hits"]["sum"] == total
    assert s["q/nodes_visited"]["sum"] == (
        s["q/aabb_tests"]["sum"] + s["q/leaf_tests"]["sum"])
    assert (s["buf/total"]["last"], s["buf/attempts"]["last"],
            s["buf/overflowed"]["last"]) == (9.0, 2.0, 1.0)
    assert (s["grid/attempts"]["last"], s["grid/capacity"]["last"]) == (3.0, 16.0)
    assert s["other"]["last"] == 7.0
    out = reg.to_json(str(tmp_path / "metrics.json"))
    with open(out) as f:
        assert json.load(f)["q/max_depth"]["last"] >= 1.0


def test_record_recompiles_counts_as_the_reference():
    """The distinct (shape, dtype) signatures of a sweep of numpy
    argument tuples: the reference's count, without importing it."""
    f32, i32 = np.zeros((4, 3), np.float32), np.zeros(4, np.int32)
    sweep = [(f32, i32), (f32, i32), (np.zeros((8, 3), np.float32), i32),
             (f32, {"a": i32, "b": (f32,)}), (f32, np.zeros(4, np.int64))]
    assert count_signatures(sweep) == count_compile_signatures(sweep) == 4
    reg = MetricsRegistry()
    reg.record_recompiles("serve", sweep)
    assert reg.summary()["serve/compile_signatures"]["last"] == 4.0
