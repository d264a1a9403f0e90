"""The port's terminal viewer (viewer/terminal.py) on the CPU.

Its pure functions against the JAX package's on the same inputs (the
ANSI frame, the input parser and the fitted resolution: equal strings
and tuples; the frame goes through the sRGB curve, which torch and XLA
round within 1.2e-7 of each other, and the seeded images here give the
same bytes), the refusal without a TTY, the package's view(), and the
port's CLI driven on a pseudo-terminal: frames, 'p' (camera state), the
dev views 2 and 3 (alias scatter, raw HDRI), back to 1, then 'q' with
exit code 0. The CLI runs as a fresh process with --device cpu, one
thread, 3 bounces and a small --hdri-dir (about 8 s here; about 20 s
beside six busy processes on eight cores).
"""

import os
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import rsoderh_raytracing_tpu_torch as rt_torch
from rsoderh_raytracing_tpu.viewer import terminal as j_terminal
from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
from rsoderh_raytracing_tpu_torch.scene.camera import KeyboardLayout
from rsoderh_raytracing_tpu_torch.viewer import terminal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALF_BLOCK = "▀".encode()


@pytest.mark.parametrize("shape,cols,rows", [
    ((32, 48), 80, 24),      # one pixel a cell
    ((128, 256), 64, 20),    # downsampled to fit
    ((16, 16), 0, -2),       # an unsized PTY
    ((24, 40), 120, 40),
])
def test_render_ansi_matches_jax(shape, cols, rows):
    g = np.random.default_rng(shape[0] + cols)
    img = (g.random((*shape, 3)) * 1.2).astype(np.float32)  # some values clip
    frame = terminal._render_ansi(img, cols, rows)
    assert frame == j_terminal._render_ansi(img, cols, rows)
    assert "\x1b[38;2;" in frame and "▀" in frame


@pytest.mark.parametrize("buf", [
    b"wA\x1b[<35;10;12M\x1b[<35;2",
    b"\x1b[<35;20;14Mq",
    b"\x1b[Aw",
    b"\x1bOAs\x1bO",
    b"\x1b",
    b"e\x1bx3\x1b[<0;1;2m\x1b[<bad;1Mp",
])
def test_parse_input_matches_jax(buf):
    assert terminal.parse_input(buf) == j_terminal.parse_input(buf)


@pytest.mark.parametrize("args", [
    (256, 144, 26, 14), (256, 144, 100, 40), (32, 24, 500, 200), (64, 48, 0, 0),
    (64, 48, -1, 2), (256, 144, 5, 4), (256, 144, 120, 40),
])
def test_fit_resolution_matches_jax(args):
    assert terminal._fit_resolution(*args) == j_terminal._fit_resolution(*args)
    assert terminal.CELL_PIXELS == j_terminal.CELL_PIXELS


def test_viewer_non_tty_refuses(house_scene, capsys):
    layout = KeyboardLayout.parse_config("wasdqe", "cpe")
    assert terminal.run_viewer(house_scene, layout, width=16, height=12, device="cpu") == 2
    assert "not a TTY" in capsys.readouterr().err


def test_view_api(house_scene):
    """rsoderh_raytracing_tpu_torch.view: validates the keyboard layout and
    exits 2 without a TTY (pytest captures stdio)."""
    assert rt_torch.view(house_scene, device="cpu") == 2
    with pytest.raises(ValueError):
        rt_torch.view(house_scene, movement_keys="abc")


@pytest.mark.skipif(sys.platform != "linux", reason="needs pty")
def test_viewer_pty_end_to_end(assets_dir, tmp_path):
    """The CLI's viewer on a pseudo-terminal of 120x40 cells: frames with
    a growing spp=, 'p' prints the camera state, dev views 2 and 3 and
    back to 1, then 'q' exits with 0."""
    import fcntl
    import pty
    import struct
    import termios

    np.save(tmp_path / "sky.npy", procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15))
    master, slave = pty.openpty()
    fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", 40, 120, 0, 0))
    proc = subprocess.Popen(
        [sys.executable, "-m", "rsoderh_raytracing_tpu_torch", "--scene",
         os.path.join(assets_dir, "scenes", "house.toml"), "--view", "--resolution", "32x24",
         "--max-bounces", "3", "--device", "cpu", "--hdri-dir", str(tmp_path)],
        stdin=slave, stdout=slave, stderr=slave, cwd=REPO,
        # one thread: beside busy test workers, torch's thread pool would
        # wait on descheduled threads at every operation
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"), close_fds=True,
    )
    os.close(slave)
    # (key, what the output since the last key must show before it is
    # sent): after the pause of 'p' the viewer drops what was typed, so
    # '2' waits for frames drawn after the pause.
    script = [
        (b"p", lambda new: new.count(b"spp=") >= 3),
        (b" ", lambda new: b"for use with --state" in new),
        (b"2", lambda new: new.count(b"spp=") >= 2),
        (b"3", lambda new: b"dev=2" in new),
        (b"1", lambda new: b"dev=3" in new),
        (b"q", lambda new: b"dev=1" in new),
    ]
    out, sent, mark = b"", 0, 0
    deadline = time.monotonic() + 120
    try:
        while time.monotonic() < deadline and proc.poll() is None:
            if select.select([master], [], [], 0.2)[0]:
                try:
                    out += os.read(master, 262144)
                except OSError:  # EIO: the viewer has closed the terminal
                    proc.wait(timeout=10)
                    break
            if sent < len(script) and script[sent][1](out[mark:]):
                mark = len(out)
                os.write(master, script[sent][0])
                sent += 1
        rc = proc.poll()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        os.close(master)

    assert sent == len(script), f"stopped at key {sent}: {out[-400:]!r}"
    assert rc == 0
    assert out.count(HALF_BLOCK) > 100, "no frames rendered"
    spps = [int(x) for x in re.findall(rb"32x24 spp=(\d+) env=0 dev=1", out)]
    assert spps and spps[-1] >= 1 and spps == sorted(spps), "progressive spp counter"
    assert b"for use with --state" in out
