"""The port's spans and counters (rsoderh_raytracing_tpu_torch/tracing.py)
and their reading over a torch.profiler trace (profiling.span_report).

CPU cases at a tiny size; the card case (marked `cuda`, skipped without
one) holds the sync counters to the syncs torch reports:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from rsoderh_raytracing_tpu_torch import load_scene, tracing
from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.ops import cuda_wavefront as cw
from rsoderh_raytracing_tpu_torch.parallel.sharding import ShardedRenderer
from rsoderh_raytracing_tpu_torch.profiling import chrome_events, span_report
from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "scenes")
W, H, BOUNCES, ITERATIONS = 16, 8, 2, 2
# The sites one CPU step_freerun passes (on the card each is a host sync).
CALL_SYNCS = {"sync.camera": 3, "sync.wavefront_setup": 1, "sync.drain": 1, "sync.stats": 1,
              "sync.min_count": 1}


@pytest.fixture(scope="module")
def house():
    return load_scene(os.path.join(SCENES, "house.toml"))


@pytest.fixture(scope="module")
def sky():
    return EnvironmentMaps([Environment.from_texture("sky", procedural_sky(32, 16))])


@pytest.fixture(autouse=True)
def tracing_off():
    """Every case starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _renderer(house, sky, device="cpu", width=W, height=H, intersector="sweep"):
    return Renderer(house, width, height, environments=sky, max_bounces=BOUNCES,
                    intersector=intersector, device=device)


def _spans_by_name(spans, name):
    return [sp for sp in spans if sp["name"] == name]


def test_off_records_nothing_and_on_renders_the_same(house, sky):
    assert tracing.span("wavefront.step", True, it=0) is tracing.OFF
    off = _renderer(house, sky)
    off.step_freerun(ITERATIONS)
    off.film.tonemapped()
    assert tracing.take() == {"spans": [], "counters": {}}

    tracing.enable()
    on = _renderer(house, sky)
    on.step_freerun(ITERATIONS)
    rec = tracing.take()
    assert rec["spans"] and rec["counters"]
    assert torch.equal(on.film.cumulative, off.film.cumulative)
    assert torch.equal(on.film.counts, off.film.counts)
    assert on.last_stats == off.last_stats


def test_launch_counters_count_while_tracing_is_on(monkeypatch):
    monkeypatch.setitem(cw.LAUNCHES, "trace", 0)
    cw.LAUNCHES["trace"] += 2
    assert tracing.take() == {"spans": [], "counters": {}}
    tracing.enable()
    cw.LAUNCHES["trace"] += 3
    tracing.disable()
    cw.LAUNCHES["trace"] += 5
    assert tracing.take()["counters"] == {"launch.trace": 3}


def test_a_call_is_one_root_with_nested_children(house, sky):
    r = _renderer(house, sky)
    r.step_freerun(ITERATIONS)
    tracing.enable()
    r.step_freerun(ITERATIONS)
    spans = tracing.take()["spans"]
    roots = [sp for sp in spans if sp["parent"] is None]
    assert [sp["name"] for sp in roots] == ["renderer.step_freerun"]
    root = roots[0]
    by_id = {sp["id"]: sp for sp in spans}
    assert len(by_id) == len(spans)
    for sp in spans:
        assert sp["call"] == root["id"]
        assert sp["start"] <= sp["end"]
        if sp is not root:
            parent = by_id[sp["parent"]]
            assert parent["start"] <= sp["start"] and sp["end"] <= parent["end"]
    steps = _spans_by_name(spans, "wavefront.step")
    assert len(steps) == ITERATIONS + BOUNCES - 1  # Wavefront.drain_iterations()
    assert [sp["attrs"]["it"] for sp in steps] == list(range(len(steps)))
    assert all(sp["parent"] == root["id"] for sp in steps)
    parts = [sp for sp in spans if sp["name"].startswith("step.")]
    assert {sp["name"] for sp in parts} == {"step.trace", "step.shade"}
    assert {sp["parent"] for sp in parts} == {sp["id"] for sp in steps}
    for name in ("wavefront.setup", "wavefront.drain_check", "wavefront.results", "film.add",
                 "renderer.stats", "film.min_count"):
        assert len(_spans_by_name(spans, name)) == 1, name
    assert "device_ms" not in parts[0]


def test_spans_share_the_profilers_clock(house, sky):
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with record_function("inside"):
                torch.ones(64).sum()
    spans = tracing.take()["spans"]
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"tracing_clock_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        _, _, notes = chrome_events(path)
    finally:
        os.remove(path)
    (outer,) = spans
    lo, hi = notes["inside"]
    assert outer["start"] <= lo <= hi <= outer["end"]


def test_sync_counters_count_the_known_sites(house, sky, tmp_path):
    r = _renderer(house, sky)
    r.step_freerun(ITERATIONS)
    tracing.enable()
    r.step_freerun(ITERATIONS)
    assert tracing.take()["counters"] == CALL_SYNCS
    r.film.tonemapped()
    rec = tracing.take()
    assert rec["counters"] == {"sync.tonemap": 3, "sync.readback": 1}
    assert [sp["name"] for sp in rec["spans"]] == ["film.tonemap", "film.readback"]
    path = str(tmp_path / "film.npz")
    r.save_checkpoint(path)
    r.load_checkpoint(path)
    rec = tracing.take()
    assert rec["counters"] == {"sync.checkpoint_save": 2, "sync.checkpoint_load": 2}
    assert [sp["name"] for sp in rec["spans"]] == ["film.load_checkpoint"]


def test_sharded_steps_carry_their_slot(house, sky):
    inner = _renderer(house, sky)
    sharded = ShardedRenderer.wrap(inner, "tile:2,dp:2")
    tracing.enable()
    sharded.step_freerun(ITERATIONS)
    rec = tracing.take()
    spans = rec["spans"]
    assert [sp["name"] for sp in spans if sp["parent"] is None] == ["renderer.step_freerun"]
    steps = _spans_by_name(spans, "wavefront.step")
    iterations = ITERATIONS + BOUNCES - 1
    slots = [tuple(sp["attrs"]["slot"]) for sp in steps]
    assert sorted(set(slots)) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(slots.count(s) == iterations for s in set(slots))
    assert [sp["attrs"]["it"] for sp in steps] == [i for i in range(iterations) for _ in range(4)]
    assert rec["counters"]["sync.drain"] == 4 and rec["counters"]["sync.stats"] == 1


def test_span_report_reads_a_made_up_stretch():
    ms = 1_000_000

    def span(name, sid, parent, start, end):
        return dict(name=name, id=sid, parent=parent, call=1, start=start * ms, end=end * ms, attrs={})

    spans = [span("renderer.step_freerun", 1, None, 0, 100),
             span("wavefront.step", 2, 1, 10, 20), span("step.trace", 3, 2, 11, 15),
             span("wavefront.step", 4, 1, 30, 40), span("wavefront.drain_check", 5, 1, 60, 90)]
    # (name, start, end, correlation) on the host; device operations after
    runtime = [("cudaLaunchKernel", 12 * ms, 13 * ms, 1), ("cudaLaunchKernel", 16 * ms, 18 * ms, 2),
               ("cudaLaunchKernel", 32 * ms, 33 * ms, 3), ("cudaLaunchKernel", 45 * ms, 46 * ms, 4),
               ("cudaStreamSynchronize", 61 * ms, 89 * ms, None)]
    ops = [("trace_kernel", 0, 14 * ms, 25 * ms, 1), ("shade_kernel", 0, 25 * ms, 30 * ms, 2),
           ("trace_kernel", 0, 35 * ms, 60 * ms, 3), ("elementwise", 0, 60 * ms, 70 * ms, 4),
           ("memcpy", 0, 100 * ms, 105 * ms, None)]
    counters = {"sync.drain": 1, "sync.stats": 1, "launch.trace": 2}
    got = span_report(spans, counters, ops, runtime, (0, 110 * ms))
    assert got["steps"] == 2 and got["calls"] == 1
    assert got["enqueue_ms_per_iter"] == pytest.approx(((10 - 3) + (10 - 1)) / 2)
    assert got["launches_per_iter"] == pytest.approx(3 / 2)
    # idle, by the span open at each gap's start: [0, 14) the root, [30,
    # 35) the second step, [70, 100) the drain check, [105, 110) none
    assert got["idle_ms"] == pytest.approx({"renderer.step_freerun": 14.0, "wavefront.step": 5.0,
                                            "wavefront.drain_check": 30.0, "outside": 5.0})
    assert got["stall_ms"] == pytest.approx(49.0)
    assert got["inside_share"] == pytest.approx(49.0 / 54.0)
    assert got["syncs_per_call"] == 2
    assert got["clock_share"] == pytest.approx(1.0) and got["clock_max_ms"] == 0
    late = [r if r[3] != 3 else ("cudaLaunchKernel", 41 * ms, 42 * ms, 3) for r in runtime]
    got = span_report(spans, counters, ops, late, (0, 110 * ms))
    assert got["clock_share"] == pytest.approx(2 / 3) and got["clock_max_ms"] == pytest.approx(2.0)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _syncs_reported(fn):
    """The syncs torch reports (set_sync_debug_mode("warn")) while fn runs,
    and the CUDA events made."""
    made = []
    event = torch.cuda.Event

    def counted(*args, **kwargs):
        made.append(1)
        return event(*args, **kwargs)

    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.Event = counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.Event = event
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught), len(made)


@pytest.mark.cuda
@pytest.mark.parametrize("intersector", ["sweep", "bvh"])
def test_card_syncs_match_the_sync_counters(card, house, sky, intersector):
    r = _renderer(house, sky, card, 256, 256, intersector)
    r.step_freerun(8)
    r.film.tonemapped()
    torch.cuda.synchronize()

    def frame():
        r.step_freerun(8)
        r.film.tonemapped()

    off_syncs, off_events = _syncs_reported(frame)
    assert tracing.take() == {"spans": [], "counters": {}}
    tracing.enable()
    on_syncs, on_events = _syncs_reported(frame)
    counters = tracing.take()["counters"]
    counted = sum(v for k, v in counters.items() if k.startswith("sync."))
    assert off_events == 0 and on_events == 0
    assert on_syncs == off_syncs == counted, json.dumps(counters)
    tracing.enable(device_events=True)
    r.step_freerun(8)
    parts = [sp for sp in tracing.take()["spans"] if sp["name"].startswith("step.")]
    assert parts and all(sp["device_ms"] > 0.0 for sp in parts)
    assert np.isfinite([sp["device_ms"] for sp in parts]).all()
