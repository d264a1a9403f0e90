"""`correct` comes out false for the lower-precision control and for each
fault that a cell's timed path can have, and true for a sound run: whole
runs of the harness on the CPU at a tiny size (32 x 32, 2 bounces, 4
iterations a call), with the port's plain versions underneath. The
limits are the cells' own."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run, spec

TINY = ["--device", "cpu", "--width", "32", "--height", "32", "--bounces", "2", "--iterations", "4"]


def _cell(monkeypatch, config, traffic, limits_of):
    """A cell of the house configuration under `traffic`, held to the
    limits of the cell `limits_of`."""
    bench = spec.benchmark()
    base = spec.cell(next(w["name"] for w in bench["workloads"] if w["config"] == config), bench)
    with open(os.path.join(spec.HERE, "mixes", f"{traffic}.json")) as f:
        mix = json.load(f)
    cell = dict(base, mix=mix, entry=dict(base["entry"], traffic=traffic))
    limits = spec.limits(limits_of)
    monkeypatch.setattr(spec, "cell", lambda name, *a, **k: cell)
    monkeypatch.setattr(spec, "limits", lambda name, *a, **k: limits)


def _run(capsys, seed, *extra):
    assert run.main(["--workload", "test", "--seed", str(seed), "--seconds", "0.2", *TINY, *extra], 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("traffic,limits_of", [("render", "house.render"), ("frame", "suzanne_xhi.frame")])
def test_sound_run_is_correct(monkeypatch, capsys, traffic, limits_of):
    _cell(monkeypatch, "house", traffic, limits_of)
    result = _run(capsys, 2**33 + 5)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


def test_control_is_not_correct(monkeypatch, capsys):
    _cell(monkeypatch, "house", "render", "house.render")
    assert _run(capsys, 2**33 + 6, "--control", "bf16")["correct"] is False


def _unchanged(monkeypatch):
    from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

    def step_freerun(self, iterations, compact_every=None):
        self.last_stats = {"closest_rays": 0.0, "shadow_rays": 0.0, "iterations": 0}
        return self.film.sample_count

    monkeypatch.setattr(Renderer, "step_freerun", step_freerun)


def _half_batch(monkeypatch):
    from rsoderh_raytracing_tpu_torch.render import renderer

    original = renderer.render_freerun

    def render_freerun(*a, **k):
        image, counts, stats = original(*a, **k)
        half = image.shape[0] // 2
        image, counts = image.clone(), counts.clone()
        image[half:] = 0.0
        counts[half:] = 0
        return image, counts, stats

    monkeypatch.setattr(renderer, "render_freerun", render_freerun)


def _altered(monkeypatch):
    from rsoderh_raytracing_tpu_torch.render.film import Film

    original = Film.add_freerun
    monkeypatch.setattr(Film, "add_freerun", lambda self, summed, counts: original(self, summed * 1.01, counts))


def _no_exchange(monkeypatch):
    from rsoderh_raytracing_tpu_torch.parallel import sharding

    class Alone(sharding.Wavefront):
        def results(self):
            film, counts, stats = super().results()
            if self.offset:
                film, counts = torch.zeros_like(film), torch.zeros_like(counts)
            return film, counts, stats

    monkeypatch.setattr(sharding, "Wavefront", Alone)


def _no_sphere_hits(monkeypatch):
    from rsoderh_raytracing_tpu_torch.ops import intersect

    original = intersect._hits

    def _hits(scene, kind, lo, hi, r):
        t, hit = original(scene, kind, lo, hi, r)
        return t, hit & (kind != intersect.SPHERE)

    monkeypatch.setattr(intersect, "_hits", _hits)


def _film_counts_one_card(monkeypatch):
    from rsoderh_raytracing_tpu_torch.parallel import sharding

    original = sharding.render_freerun_sharded

    def render_freerun_sharded(*a, **k):
        summed, counts, shard_counts, *rest = original(*a, **k)
        slots = shard_counts.shape[0]
        return (summed, (counts + slots - 1) // slots, shard_counts, *rest)

    monkeypatch.setattr(sharding, "render_freerun_sharded", render_freerun_sharded)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _no_sphere_hits])
@pytest.mark.parametrize("traffic,limits_of", [("render", "house.render"), ("frame", "suzanne_xhi.frame")])
def test_faults_are_not_correct(monkeypatch, capsys, fault, traffic, limits_of):
    _cell(monkeypatch, "house", traffic, limits_of)
    fault(monkeypatch)
    assert _run(capsys, 2**33 + 7)["correct"] is False


def test_sharded_render(monkeypatch, capsys):
    _cell(monkeypatch, "house", "render_dp4", "suzanne_xhi.render_dp4")
    assert _run(capsys, 2**33 + 8)["correct"] is True
    _no_exchange(monkeypatch)
    assert _run(capsys, 2**33 + 8)["correct"] is False


def test_sharded_film_counts_are_checked(monkeypatch, capsys):
    """Each card's stream sound, the film's counts (the rate's numerator)
    short of their sum."""
    _cell(monkeypatch, "house", "render_dp4", "suzanne_xhi.render_dp4")
    _film_counts_one_card(monkeypatch)
    assert _run(capsys, 2**33 + 8)["correct"] is False


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "house.render", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "house.render", "--seed",
                          str(2**33 + 9), "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["kind"] == card
