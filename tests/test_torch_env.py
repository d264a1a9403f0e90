"""Port environment (env/*, ops/envmap.py) against the JAX reference,
and the port's native host builders (alias table, SAH BVH) against the
reference's, compiled privately (compile_reference_native).

The copied numpy modules and the device arrays are held bitwise equal.
The alias draw is integer work plus one f32 multiply and division, so
indices, pmf and uv are bitwise equal. The uv <-> direction maps go
through atan2/asin/sin/cos, which torch and XLA round differently
(ROADMAP queue 3): they are held to an absolute bound measured here.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsoderh_raytracing_tpu.accel import bvh as j_bvh
from rsoderh_raytracing_tpu.env import alias_table as j_alias
from rsoderh_raytracing_tpu.env import hdr_io as j_hdr
from rsoderh_raytracing_tpu.env.environment import Environment as JEnvironment
from rsoderh_raytracing_tpu.env.environment import device_environment as j_device_environment
from rsoderh_raytracing_tpu.env.environment import (
    load_default_environments as j_load_default_environments,
)
from rsoderh_raytracing_tpu.ops import envmap as jenv
from rsoderh_raytracing_tpu_torch import load_scene
from rsoderh_raytracing_tpu_torch.accel import bvh as t_bvh
from rsoderh_raytracing_tpu_torch.accel import native as t_native
from rsoderh_raytracing_tpu_torch.env import alias_table, hdr_io
from rsoderh_raytracing_tpu_torch.env.environment import (
    Environment,
    device_environment,
    device_environment_from_arrays,
    load_default_environments,
)
from rsoderh_raytracing_tpu_torch.ops import envmap, rng

torch.set_num_threads(2)

# uv and direction components lie in [-1, 1], where an ulp of the
# result says little: u = atan2(..) * k + 0.5 cancels near u = 0. They are
# held to an absolute bound instead. Measured here, torch-CPU vs XLA-CPU
# over 200k inputs: max |diff| 1.19e-7 (2^-23, one ulp at 1.0) for u, v
# and the three direction components. Bound: two ulps at 1.0.
UV_DIR_ATOL = 2.0**-22

SKIES = {
    "default": {},
    "golden": dict(sun_radius=0.05),
    "overcast": dict(sun_direction=(-0.6, 0.18, 0.78), sun_intensity=90.0,
                     sun_radius=0.035, zenith_color=(0.45, 0.52, 0.62)),
}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


REF_NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "native", "raytracing_native.cpp")


def compile_reference_native(directory):
    """The JAX package's native builders (native/raytracing_native.cpp),
    compiled with its g++ flags into `directory` and bound with its
    argtypes (rsoderh_raytracing_tpu/accel/native.py). The package's own
    loader writes native/libraytracing_native.so in place, with no
    temporary file, so a test process that loads it while another
    rebuilds it reads a half-written file; a private copy cannot race."""
    lib_path = os.path.join(str(directory), "libraytracing_native.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", REF_NATIVE_SRC, "-o", lib_path],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.build_alias_table.restype = ctypes.c_int64
    lib.build_alias_table.argtypes = [f32p, ctypes.c_int64, f32p, i32p, f32p]
    lib.build_bvh_sah.restype = ctypes.c_int64
    lib.build_bvh_sah.argtypes = [
        f32p, f32p, ctypes.c_int64, f32p, f32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    return compile_reference_native(tmp_path_factory.mktemp("reference_native"))


@pytest.fixture(scope="module")
def envs():
    sky = j_hdr.procedural_sky(128, 64, sun_radius=0.1)
    jd = j_device_environment(JEnvironment.from_texture("s", sky))
    td = device_environment(Environment.from_texture("s", sky), device="cpu")
    return jd, td


@pytest.mark.parametrize("name", sorted(SKIES))
def test_procedural_sky_bitwise(name):
    a = hdr_io.procedural_sky(96, 48, **SKIES[name])
    b = j_hdr.procedural_sky(96, 48, **SKIES[name])
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_rgbe_and_alias_table_bitwise():
    rgb = np.random.default_rng(3).exponential(2.0, (32, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(hdr_io.float_to_rgbe(rgb), j_hdr.float_to_rgbe(rgb))
    np.testing.assert_array_equal(_bits(hdr_io.rgbe_quantize(rgb)), _bits(j_hdr.rgbe_quantize(rgb)))
    w = alias_table.build_weights_by_luminance(rgb)
    np.testing.assert_array_equal(_bits(w), _bits(j_alias.build_weights_by_luminance(rgb)))
    a, b = alias_table.build_alias_table(w), j_alias.build_alias_table(w)
    np.testing.assert_array_equal(_bits(a.probability), _bits(b.probability))
    np.testing.assert_array_equal(a.alias_index, b.alias_index)
    np.testing.assert_array_equal(_bits(a.pmf), _bits(b.pmf))


def test_native_alias_builder_matches_reference_native(reference_native):
    """The port's own C++ builder, built into build/native/, against the
    reference package's native builder (a private build of its source):
    bitwise."""
    w = np.random.default_rng(4).exponential(1.0, 300_000).astype(np.float32)
    p = (w * np.float32(w.size) / np.float32(w.sum(dtype=np.float64))).astype(np.float32)
    got = alias_table.build_alias_table_native(p)
    ref = (np.empty(p.size, np.float32), np.empty(p.size, np.int32), np.empty(p.size, np.float32))
    reference_native.build_alias_table(p, p.size, *ref)
    assert got is not None
    assert alias_table._native_lib._name.startswith(alias_table.NATIVE_DIR)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _reference_native_bvh(lib, mins, maxs):
    """The reference's native SAH build (the arguments of
    rsoderh_raytracing_tpu/accel/native.build_bvh_native) through the
    private build."""
    n = len(mins)
    cap = max(1, 2 * n - 1)
    out = [np.empty((cap, 3), np.float32), np.empty((cap, 3), np.float32),
           np.empty(cap, np.int32), np.empty(cap, np.int32), np.empty(cap, np.int32)]
    order = np.empty(n, np.int32)
    depth = ctypes.c_int32(0)
    k = lib.build_bvh_sah(np.ascontiguousarray(mins, np.float32),
                          np.ascontiguousarray(maxs, np.float32), n, *out, order, ctypes.byref(depth))
    return (*(a[:k].copy() for a in out), order, int(depth.value))


@pytest.mark.parametrize("name", ["default", "house", "spheres", "random"])
def test_native_bvh_builder_matches_reference_native(reference_native, assets_dir, name):
    """The port's C++ SAH builder (csrc/bvh_build.cpp, built into
    build/native/) against the reference's native builder: every array of
    the tree and its depth bitwise, on three scenes' primitive bounds and
    2,000 random boxes; the tree validates (accel/bvh.validate_bvh)."""
    if name == "random":
        rng = np.random.default_rng(11)
        c = rng.uniform(-10.0, 10.0, (2000, 3)).astype(np.float32)
        e = rng.exponential(0.3, (2000, 3)).astype(np.float32)
        mins, maxs = c - e, c + e
        types, idx = rng.integers(0, 3, 2000).astype(np.int32), np.arange(2000, dtype=np.int32)
    else:
        scene = load_scene(os.path.join(assets_dir, "scenes", f"{name}.toml"))
        mins, maxs, types, idx = t_bvh.scene_primitive_bounds(scene)
    native = t_native.build_bvh_native(mins, maxs)
    assert native is not None and t_native._bvh_lib._name.startswith(t_native.NATIVE_DIR)
    got = t_bvh._assemble(native, types, idx)
    ref = j_bvh._assemble(_reference_native_bvh(reference_native, mins, maxs), types, idx)
    for f in ("nodes_min", "nodes_max", "node_payload", "node_count", "node_axis",
              "prim_type", "prim_index"):
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(ref, f)), err_msg=f)
    assert got.depth == ref.depth < t_bvh.TRAVERSAL_STACK_DEPTH
    t_bvh.validate_bvh(got, mins, maxs, order_types=types)
    assert got.node_count.max() <= t_bvh.MAX_PRIMITIVES_PER_LEAF


def test_default_environments_bitwise():
    """load_default_environments (the anchor goldens' environments): the
    same HDRIs in the same order, textures and alias tables bitwise."""
    got, ref = load_default_environments(), j_load_default_environments()
    assert [e.name for e in got.environments] == [e.name for e in ref.environments]
    assert got.next_index(len(got) - 1) == 0
    for a, b in zip(got.environments, ref.environments):
        np.testing.assert_array_equal(_bits(a.texture), _bits(b.texture))
        np.testing.assert_array_equal(_bits(a.alias.probability), _bits(b.alias.probability))
        np.testing.assert_array_equal(a.alias.alias_index, b.alias.alias_index)
        np.testing.assert_array_equal(_bits(a.alias.pmf), _bits(b.alias.pmf))
        assert a.weight_sum == b.weight_sum


def test_device_environment_bitwise(envs):
    jd, td = envs
    assert td.texture_shape == tuple(jd.texture_shape)
    np.testing.assert_array_equal(td.quad.numpy().view(np.uint32), np.asarray(jd.quad))
    np.testing.assert_array_equal(_bits(td.alias_pair.numpy()), _bits(jd.alias_pair))
    np.testing.assert_array_equal(_bits(td.pmf_norm.numpy()), _bits(jd.pmf_norm))
    np.testing.assert_array_equal(
        td.alias_index.numpy(), np.asarray(jd.alias_pair)[:, 1].view(np.int32)
    )


def test_device_environment_from_arrays_round_trip(envs):
    jd, td = envs
    rt = device_environment_from_arrays(
        jd.texture_shape, np.asarray(jd.quad), np.asarray(jd.alias_pair),
        np.asarray(jd.pmf_norm), device="cpu",
    )
    for name in ("quad", "alias_pair", "pmf_norm", "alias_index"):
        np.testing.assert_array_equal(
            _bits(getattr(rt, name).numpy()), _bits(getattr(td, name).numpy())
        )


def test_sample_alias_index_equal(envs):
    jd, td = envs
    state = np.random.default_rng(5).integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    js, jidx, juv, jpmf = jenv.sample_alias_index(jnp.asarray(state), jd)
    ts, tidx, tu, tv, tpmf = envmap.sample_alias_index(
        torch.from_numpy(state.astype(np.int64)), td
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(tpmf.numpy()), _bits(jpmf))
    np.testing.assert_array_equal(_bits(tu.numpy()), _bits(np.asarray(juv)[:, 0]))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(np.asarray(juv)[:, 1]))


def test_decode_rgbe_bitwise():
    g = np.random.default_rng(9)
    words = g.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    words[:1000] &= 0x00FFFFFF  # e == 0: black
    ref = np.asarray(jenv.decode_rgbe(jnp.asarray(words)))
    r, gg, b = envmap.decode_rgbe(torch.from_numpy(words.view(np.int32)))
    got = np.stack([r.numpy(), gg.numpy(), b.numpy()], axis=-1)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_direction_to_uv_bound():
    d = np.random.default_rng(11).normal(size=(200_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jenv.direction_to_equirect_uv(jnp.asarray(d)))
    u, v = envmap.direction_to_equirect_uv(*(torch.from_numpy(d[:, k].copy()) for k in range(3)))
    assert np.abs(u.numpy() - ref[:, 0]).max() <= UV_DIR_ATOL
    assert np.abs(v.numpy() - ref[:, 1]).max() <= UV_DIR_ATOL


def test_uv_to_direction_bound():
    uv = np.random.default_rng(13).random((200_000, 2), dtype=np.float32)
    ref = np.asarray(jenv.equirect_uv_to_direction(jnp.asarray(uv)))
    got = envmap.equirect_uv_to_direction(torch.from_numpy(uv[:, 0].copy()), torch.from_numpy(uv[:, 1].copy()))
    for k in range(3):
        assert np.abs(got[k].numpy() - ref[:, k]).max() <= UV_DIR_ATOL


def test_radiance_and_pmf_close(envs):
    """One quad-row fetch: the bilinear radiance is exact arithmetic on
    decoded texels (bitwise), the pmf goes through sin (1e-6 relative)."""
    jd, td = envs
    uv = np.random.default_rng(17).random((100_000, 2), dtype=np.float32)
    uv[:10] = [[1.0, 1.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 1.0],
               [1e-7, 0.5], [0.99999994, 0.5], [0.25, 1e-7], [0.3, 0.99999994], [0.0, 0.5]]
    jr, jp = jenv.radiance_and_pmf(jd, jnp.asarray(uv))
    (r, g, b), p = envmap.radiance_and_pmf(td, torch.from_numpy(uv[:, 0].copy()), torch.from_numpy(uv[:, 1].copy()))
    got = np.stack([r.numpy(), g.numpy(), b.numpy()], axis=-1)
    np.testing.assert_array_equal(_bits(got), _bits(jr))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=0)


def test_float_to_int_saturates():
    x = torch.tensor([float("nan"), 1e20, -1e20, -0.7, 2.9, -2.9])
    assert envmap.float_to_int(x).tolist() == [0, 2147483647, -2147483648, 0, 2, -2]
    assert rng.to_bits(torch.tensor([2**32 - 1])).tolist() == [-1]
