"""What the benchmark loads: the harness and the port load no JAX and no
JAX package, and the reference loads nothing of the port. Top-level
module names are compared whole: the port's name begins with the JAX
package's."""

import subprocess
import sys

from portbench import run, spec

HARNESS = ["portbench.run", "portbench.check", "portbench.counts", "portbench.program", "portbench.scenes",
           "portbench.spec", "portbench.stats", "portbench.traffic"]
REFERENCE = ["portbench.reference." + m for m in ("bsdf", "env", "envmap", "integrator", "intersect", "rng",
                                                  "scene")]


def _top_level(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    names = _top_level(HARNESS + REFERENCE + ["rsoderh_raytracing_tpu_torch.render.renderer",
                                              "rsoderh_raytracing_tpu_torch.parallel.sharding"])
    assert "rsoderh_raytracing_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rsoderh_raytracing_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _top_level(REFERENCE + ["portbench.check", "portbench.counts"])
    assert "rsoderh_raytracing_tpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "rsoderh_raytracing_tpu"}


def test_the_run_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "rsoderh_raytracing_tpu_torch_extra", object())
    assert "jaxlib" in run.forbidden_modules()
    assert "rsoderh_raytracing_tpu_torch_extra" not in run.forbidden_modules()
