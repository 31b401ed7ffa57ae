"""The port's spans and counters (``repro_torch.runtime.spans``).

Recording is on only inside a ``torch.profiler`` session; off, ``span``
and ``count`` touch nothing (``torch.cuda`` included).  Inside one, spans
nest with their parents and identifiers, their host times share the
profiler's clock, and the buffer keeps its bound.  ``fit_partitions`` on
a world of one (gloo, in-process) and ``GSRenderServer`` at the parity
tests' tiny sizes give the named spans in their nesting, ``serve.assign``
only for misses, the collectives' ``wire_bytes`` by the ring count, and
the same losses and images bit for bit with and without the profiler.
"""

import collections
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.cameras import orbital_rig  # noqa: E402
from repro_torch.core.gaussians import Gaussians, from_points  # noqa: E402
from repro_torch.core.serving import GSRenderServer, ServeCfg  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402
from repro_torch.core.train import GSTrainCfg  # noqa: E402
from repro_torch.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]


def profiled():
    return torch.profiler.profile(activities=CPU)


@pytest.fixture
def fresh():
    spans.clear()
    yield
    spans.clear()


def _spans(recs, name=None):
    return [r for r in recs if isinstance(r, spans.Span)
            and (name is None or r.name == name)]


def _by_seq(recs):
    return {r.seq: r for r in _spans(recs)}


def test_nothing_recorded_outside_a_profiler(fresh):
    with spans.span("a", 1) as s:
        s.tag(2)
        spans.count("c", 3)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.records() == [] and spans.dropped() == 0


def test_off_never_touches_cuda(fresh, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.cuda touched with recording off")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", boom)
    with spans.span("a"):
        spans.count("c", 1)
    assert spans.records() == []


def test_nesting_parents_ids_and_counters(fresh):
    with profiled():
        assert torch.autograd.profiler._is_profiler_enabled
        with spans.span("outer", 7):
            with spans.span("inner") as s:
                s.tag([1, 2])
                spans.count("bytes", 10)
            spans.count("bytes", 5)
        spans.count("loose", 1)
    recs = spans.records()
    outer, inner = _spans(recs, "outer")[0], _spans(recs, "inner")[0]
    assert (outer.ids, outer.parent) == (7, None)
    assert (inner.ids, inner.parent) == ([1, 2], outer.seq)
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    counters = [(c.name, c.value, c.parent) for c in recs
                if isinstance(c, spans.Counter)]
    assert counters == [("bytes", 10, inner.seq), ("bytes", 5, outer.seq),
                        ("loose", 1, None)]
    # no CUDA on this machine: no device marks
    assert inner.device_ms() is None


def test_span_holds_its_ops_kineto_interval(fresh):
    """The spans' host clock is the profiler's: an op run inside a span
    has its kineto event inside the span's interval."""
    a = torch.randn(128, 128)
    with profiled() as prof:
        with spans.span("mm"):
            a @ a
    sp = _spans(spans.records(), "mm")[0]
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert evs
    for e in evs:
        assert sp.t0_ns <= e.start_ns() <= e.end_ns() <= sp.t1_ns


def test_buffer_bound_and_drop_count(fresh, monkeypatch):
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=3))
    with profiled():
        for i in range(5):
            with spans.span("s", i):
                pass
    assert [r.ids for r in spans.records()] == [2, 3, 4]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_profiler_stop_inside_a_span_keeps_it(fresh):
    prof = profiled()
    prof.__enter__()
    with spans.span("kept"):
        prof.__exit__(None, None, None)
        with spans.span("after"):
            spans.count("after", 1)
    recs = spans.records()
    assert [r.name for r in recs] == ["kept"]
    assert recs[0].t1_ns >= recs[0].t0_ns > 0


def test_threads_nest_apart_and_borrow_the_main_threads_span(fresh):
    """A thread with no open span (autograd's device threads) records its
    counters under the main thread's innermost span; a thread's own spans
    nest on its own stack."""
    done = threading.Event()

    def worker():
        spans.count("from_thread", 1)
        with spans.span("thread_span"):
            pass
        done.set()

    with profiled():
        with spans.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    assert done.is_set()
    recs = spans.records()
    main = _spans(recs, "main")[0]
    ts = _spans(recs, "thread_span")[0]
    c = [r for r in recs if isinstance(r, spans.Counter)][0]
    assert c.parent == main.seq and ts.parent == main.seq


def test_collectives_count_ring_bytes(fresh, monkeypatch):
    """``wire_bytes`` of each collective primitive on a group of four (the
    collectives themselves stubbed): all-gather 3 blocks, reduce-scatter 3
    chunks, all-reduce 2 * 3 / 4 of the tensor, all-to-all 3 / 4, a shift
    its slab."""
    for fn in ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single"):
        monkeypatch.setattr(dist, fn, lambda *a, **k: None)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    x = torch.zeros(8, 4)                                   # 128 bytes
    with profiled():
        D._all_gather(x, "g", 0)
        D._reduce_scatter(x, "g", 0)
        D._all_reduce(x, dist.ReduceOp.SUM, "g")
        D._all_to_all(x, "g")
    got = [c.value for c in spans.records()
           if isinstance(c, spans.Counter) and c.name == "wire_bytes"]
    assert got == [3 * 128, 3 * 32, 2 * 3 * 128 // 4, 3 * 128 // 4]


# ---------------------------------------------------------------------------
# the trainer and the render server
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    # the CPU scatter-adds are otherwise not bit-reproducible run to run
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture
def world1():
    made = not dist.is_initialized()
    mesh_mod.init_distributed("cpu")
    yield mesh_mod.make_mesh((1, 1), ("part", "view"))
    if made:
        mesh_mod.destroy_distributed()


def _fit(mesh, steps=3):
    pts, cols = point_cloud_for("sphere_shell", 96)
    g = from_points(pts[:96], cols[:96], capacity=128, opacity=0.7,
                    device="cpu")
    g = Gaussians(*(torch.stack([f, f]) for f in g))
    cams = orbital_rig(4, (0.5, 0.5, 0.5), 1.6, width=32, height=32,
                       device="cpu")
    gts = torch.stack([torch.full((4, 32, 32, 3), c) for c in (0.5, 0.3)])
    cfg = GSTrainCfg(K=8, tile_h=8, tile_w=16, lr_colors=5e-2)
    times = []
    _, _, losses = D.fit_partitions(
        g, cams, gts, None, cfg, mesh=mesh, steps=steps, extent=1.0,
        grid=TileGrid(32, 32, 8, 16), view_batch=1, step_times=times)
    return losses, times


STEP_CHILDREN = ["train.batch", "train.forward", "train.backward",
                 "train.adam", "train.readback", "train.schedule"]


def test_fit_partitions_spans_and_same_losses(fresh, deterministic, world1):
    plain, _ = _fit(world1)
    with profiled():
        traced, times = _fit(world1)
    assert traced == plain                           # bit for bit
    assert len(times) == 3
    recs = spans.records()
    seqs = _by_seq(recs)
    steps = _spans(recs, "train.step")
    assert [s.ids for s in steps] == [0, 1, 2]
    for st in steps:
        kids = [r for r in _spans(recs) if r.parent == st.seq]
        assert [k.name for k in kids] == STEP_CHILDREN
        fwd = kids[1]
        inner = [r.name for r in _spans(recs) if r.parent == fwd.seq]
        # one projection of the shard's partitions, then the (identity)
        # gather
        assert inner == ["project", "train.gather"]
    # every projection of the steps sits in a forward; the probes' outside
    for p in _spans(recs, "project"):
        parent = seqs.get(p.parent)
        assert parent is None or parent.name == "train.forward"
    # one rank: no collective, no wire bytes
    assert not [c for c in recs if isinstance(c, spans.Counter)]


def _server():
    pts, cols = point_cloud_for("sphere_shell", 300)
    g = from_points(pts, cols, opacity=0.9, device="cpu")
    return GSRenderServer(g, TileGrid(32, 32, 8, 16),
                          ServeCfg(K=16, max_batch=2),
                          center=(0.5, 0.5, 0.5))


def test_render_server_spans_and_same_images(fresh):
    rig = orbital_rig(4, (0.5, 0.5, 0.5), 1.5, width=32, height=32,
                      device="cpu")
    plain = _server()
    want = [plain.serve(rig) for _ in range(2)]
    srv = _server()
    with profiled():
        cold = srv.serve(rig)
        mark = time.time_ns()
        warm = srv.serve(rig)
    for got, exp in zip((cold, warm), want):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a.rgb, b.rgb)
            np.testing.assert_array_equal(a.coverage, b.coverage)
    assert srv.telemetry() == plain.telemetry()
    recs = spans.records()
    seqs = _by_seq(recs)
    assert [s.ids for s in _spans(recs, "serve.submit")] == list(range(8))
    assert len(_spans(recs, "serve.flush")) == 2
    batches = _spans(recs, "serve.dispatch")
    assert [b.ids for b in batches] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    for b in batches:
        assert seqs[b.parent].name == "serve.flush"
        kids = [r.name for r in _spans(recs) if r.parent == b.seq]
        assert kids == ["serve.tables", "serve.render", "serve.readback"]
    # assignment only for the cold pass's misses, inside serve.tables
    assign = _spans(recs, "serve.assign")
    assert len(assign) == 2 and all(a.t1_ns < mark for a in assign)
    assert {seqs[a.parent].name for a in assign} == {"serve.tables"}
    # a cold batch projects twice (assignment, render), a warm one once
    proj = [seqs[p.parent].name for p in _spans(recs, "project")]
    assert proj.count("serve.assign") == 2
    assert proj.count("serve.render") == 4
    rb = [c for c in recs if isinstance(c, spans.Counter)]
    assert [c.name for c in rb] == ["readback_bytes"] * 4
    assert {seqs[c.parent].name for c in rb} == {"serve.readback"}
    assert all(c.value == 2 * 32 * 32 * 4 * 4 for c in rb)
