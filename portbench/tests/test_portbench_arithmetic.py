"""The benchmark's own arithmetic on made-up records: rates over the whole
window, percentiles over every frame, the idle share of a trace with a
gap, and a kernel's operations and bytes on a tiny scene by hand."""

import numpy as np
import pytest
import torch

from portbench import counts, spec, stats, traffic
from portbench.reference.env import RefEnvironment
from portbench.reference.scene import RefScene


def test_rate_is_over_the_whole_window():
    calls = [dict(start=0.0, end=1.0, samples=100), dict(start=1.0, end=4.0, samples=100)]
    run = dict(kind="render", window=(0.0, 4.0), samples=200, calls=calls)
    # 200 samples in 4 s, not the median (or mean) of 100/s and 33/s
    assert spec.reader("msamples_per_s")(run) == pytest.approx(50.0 / 1e6)


def test_p95_is_over_every_frame():
    frames = [dict(start=0.0, end=0.010) for _ in range(95)] + [dict(start=0.0, end=0.100) for _ in range(5)]
    run = dict(kind="frame", frames=frames, window=(0.0, 1.0))
    assert spec.reader("frame_ms_p95")(run) == pytest.approx(10.0)
    frames.append(dict(start=0.0, end=0.100))
    assert spec.reader("frame_ms_p95")(run) == pytest.approx(100.0)
    assert spec.reader("frames_per_s")(run) == pytest.approx(101.0)


def test_flight_is_the_controllers_and_the_same_for_every_seed():
    """The frame mix's flight is what the port's fly controller flies under
    those keys and mouse moves at that frame time, and two seeds fly the
    same frames from other starts."""
    from rsoderh_raytracing_tpu_torch.scene.camera import Camera, CameraController, ControllerConfig

    mix = spec.cell("suzanne_xhi.frame")["mix"]
    cam = mix["camera"]
    start = (np.array([0.0, 0.4, 3.0], np.float32), 0.0, -0.0872664626)
    frames = traffic.flight(cam, start)
    ctrl = CameraController(ControllerConfig(max_speed=cam["max_speed"], acceleration=cam["acceleration"],
                                             friction=cam["friction"], turn_factor=cam["turn_deg_per_px"]))
    view = Camera(pos=start[0], yaw=start[1], pitch=start[2], fov_y=1.0)
    expected = []
    for leg in cam["legs"]:
        for key in leg["keys"]:
            ctrl.set_key(key, True)
        for _ in range(leg["frames"]):
            ctrl.add_mouse_delta(*leg["mouse_px"])
            view = ctrl.update(view, cam["frame_s"])
            expected.append(view)
        for key in leg["keys"]:
            ctrl.set_key(key, False)
    assert len(frames) == len(expected) == sum(leg["frames"] for leg in cam["legs"])
    for (pos, yaw, pitch), e in zip(frames, expected):
        assert np.array_equal(pos, e.pos) and (yaw, pitch) == (e.yaw, e.pitch)
    n = len(frames)
    runs = [[next(p) for _ in range(n)] for p in (traffic.fly_path(s, mix, start) for s in (1, 2**33 + 1))]
    keys = [sorted((tuple(p.tolist()), y, q) for p, y, q in r) for r in runs]
    assert keys[0] == keys[1] == sorted((tuple(p.tolist()), y, q) for p, y, q in frames)


def test_idle_share_of_a_trace_with_a_gap():
    ops = [("a", 0, 0.0, 0.4), ("b", 0, 0.3, 0.5), ("c", 0, 0.8, 1.0), ("d", 1, 0.0, 1.0)]
    # card 0 is busy 0.0-0.5 and 0.8-1.0: idle 30%; card 1 never idle
    assert stats.idle_pct(ops, (0.0, 1.0), [0, 1]) == pytest.approx(30.0)
    assert stats.device_busy(ops, (0.0, 1.0), [0, 1]) == pytest.approx({0: 0.7, 1: 1.0})
    gaps = stats.idle_gaps(ops, [("aten::copy_", 0.5, 0.9)], (0.0, 1.0), 0)
    assert gaps == [["aten::copy_", pytest.approx(0.3)]]
    run = dict(kind="render", cards=2, trace=dict(ops=ops, window=(0.0, 1.0), devices=[0, 1], iterations=2))
    assert spec.reader("idle_pct.render")(run) == pytest.approx(30.0)
    # a, b and c on card 0 are glue (no kernel of the port): 0.8 s of device
    # time, overlapping or not, over 2 iterations
    assert spec.reader("glue_ms_per_iter.render")(run) == pytest.approx(400.0)


def test_kernel_groups():
    assert stats.kernel_group("void (anonymous namespace)::trace_kernel<true>(TraceArgs)") == "trace"
    assert stats.kernel_group("(anonymous namespace)::big_shade_kernel(BigShadeArgs)") == "big_shade"
    assert stats.kernel_group("void walk_kernel<(anonymous namespace)::Any>(x)") == "bvh_any"
    assert stats.kernel_group("void walk_kernel<(anonymous namespace)::Closest>(x)") == "bvh_closest"
    assert stats.kernel_group("void at::native::vectorized_gather_kernel<16, int>(x)") == "gather"
    assert stats.kernel_group("Memset (Device)") == "glue"


def test_least_time_takes_the_larger_bound():
    assert stats.least_seconds(3.35e12, 1.0) == (pytest.approx(1.0), "bytes")
    assert stats.least_seconds(1.0, 67e12 * 2) == (pytest.approx(2.0), "operations")


def _plane_scene():
    """One 20 x 20 ground plane at y = 0, no sphere, no triangle."""
    z3 = torch.zeros((0, 3))
    t = dict(
        mat_color=torch.ones((1, 3)), mat_roughness=torch.ones(1), mat_metallic=torch.zeros(1),
        mat_emission=torch.zeros((1, 3)),
        sph_pos=z3, sph_radius=torch.zeros(0), sph_material=torch.zeros(0, dtype=torch.int32),
        sph_c2=torch.zeros(0),
        pln_pos=torch.tensor([[-10.0, 0.0, -10.0]]), pln_normal=torch.tensor([[0.0, 1.0, 0.0]]),
        pln_material=torch.zeros(1, dtype=torch.int32),
        pln_r0=torch.tensor([[0.05, 0.0, 0.0]]), pln_r2=torch.tensor([[0.0, 0.0, 0.05]]),
        tri_a=z3, tri_edge0=z3, tri_edge1=z3, tri_n0=z3, tri_n1=z3, tri_n2=z3,
        tri_material=torch.zeros(0, dtype=torch.int32), tri_cdet=z3, tri_cu=z3, tri_cv=z3, tri_n=z3,
        tri_adotn=torch.zeros(0),
    )
    t["pln_ndotp"] = (t["pln_normal"] * t["pln_pos"]).sum(-1)
    t["pln_r0dotp"] = (t["pln_r0"] * t["pln_pos"]).sum(-1)
    t["pln_r2dotp"] = (t["pln_r2"] * t["pln_pos"]).sum(-1)
    return RefScene(t=t, camera=None)


def test_trace_counts_by_hand():
    scene = _plane_scene()
    words = np.array([1, 0, 0, 0], np.uint32).view(np.int32)
    env = RefEnvironment(texture_shape=(1, 1), quad=torch.from_numpy(np.tile(words, (1, 1))),
                         alias_pair=torch.tensor([[1.0, 0.0, 1.0, 1.0]]),
                         alias_index=torch.zeros(1, dtype=torch.int32), pmf_norm=torch.tensor([1.0, 1.0]))
    carry = dict(state=torch.tensor([1, 2, 3], dtype=torch.int32), in_path=torch.tensor([1, 1, 0]),
                 ro0=torch.zeros(3), ro1=torch.ones(3), ro2=torch.zeros(3),
                 rd0=torch.zeros(3), rd1=torch.tensor([-1.0, 1.0, -1.0]), rd2=torch.zeros(3))
    n_bytes, ops = counts.trace_counts(carry, scene, env)
    # two live lanes sweep the one plane (33 operations each); the one that
    # hits it (downwards) also tests it once for occlusion
    assert ops == 2 * 33 + 1 * 33
    # three lanes: 7 words in, 26 out, 16-byte alias, quad and quad-out rows
    assert n_bytes == 3 * 4 * (7 + 26) + 3 * 16 * 3
