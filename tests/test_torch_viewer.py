"""rt_tpu_torch.viewer against rt_tpu.viewer, and the port's interactive
surfaces driven end to end on the CPU:

* ``ansi_preview`` strings equal JAX's, on tests/test_viewer.py's images
  and a random frame;
* ``interactive`` through a real pty (tests/test_interactive.py's cases):
  renderer cycling, the low-res switch on movement, hot reload with the
  camera kept, quit; RMB drag-look and SIGWINCH resize;
* ``cli --watch`` re-renders on a change and keeps the scene on a bad one.

Every read has a deadline and every child is killed in a ``finally``."""

import fcntl
import os
import re
import select
import signal
import struct
import subprocess
import sys
import termios
import time

import numpy as np
import pytest
import torch

from rt_tpu.viewer import ansi_preview as j_ansi
from rt_tpu_torch.viewer import ansi_preview as t_ansi
from test_torch_common import SCENES

REPO = SCENES.parent

SCENE = """
samples_per_pixel = 1
max_bounces = 2
materials = [ { type = 'lambert', albedo = 'red' } ]
spheres = [ { material = 0, position = [0.0, 1.0, -3.0], radius = 0.5 } ]
"""


def _images():
    a = np.zeros((8, 10, 3), np.float32)
    a[:4] = [1.0, 0.0, 0.0]
    rng = np.random.default_rng(21)
    return [(a, 10), (np.ones((100, 400, 3), np.float32), 100),
            (np.ones((3, 4, 3), np.float32) * 0.5, 4),
            (rng.uniform(-0.2, 1.2, (75, 101, 3)).astype(np.float32), 40),
            (rng.uniform(0.0, 1.0, (6, 5, 4)).astype(np.float32), 100)]


@pytest.mark.parametrize("k", range(5))
def test_ansi_preview_equal(k):
    img, width = _images()[k]
    want = j_ansi(img, max_width=width)
    assert t_ansi(img, max_width=width) == want
    assert t_ansi(torch.from_numpy(img), max_width=width) == want


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("RT_VIEWER_DEBUG", "RT_TPU_DEBUG")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # small frames; parallel test workers share the cores
    env.update(extra)
    return env


def _read_until(fd, pattern, timeout=60.0, proc=None):
    """Read from fd until ``pattern`` (regex) appears; returns the buffer."""
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r, _, _ = select.select([fd], [], [], 0.25)
        if r:
            try:
                chunk = os.read(fd, 65536)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            if re.search(pattern, buf.decode("utf-8", "replace")):
                return buf.decode("utf-8", "replace")
        if proc is not None and proc.poll() is not None and not r:
            raise AssertionError(
                f"child exited rc={proc.returncode} before {pattern!r}; "
                f"got: {buf.decode('utf-8', 'replace')[-800:]!r}")
    raise AssertionError(
        f"pattern {pattern!r} not seen; got: {buf.decode('utf-8', 'replace')[-800:]!r}")


def _viewer(scene_file, env, rows_cols=None, size=(48, 28)):
    import pty

    master, slave = pty.openpty()
    if rows_cols:
        fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", *rows_cols, 0, 0))
    code = ("from rt_tpu_torch.viewer import interactive;"
            f"interactive({str(scene_file)!r}, 'null', size={size!r}, device='cpu')")
    proc = subprocess.Popen([sys.executable, "-c", code], stdin=slave, stdout=slave,
                            stderr=subprocess.DEVNULL, env=env, cwd=REPO, close_fds=True)
    os.close(slave)
    return master, proc


def _close(master, proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    os.close(master)


def test_viewer_interactive_pty(tmp_path):
    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)
    master, proc = _viewer(scene_file, _child_env())
    try:
        # initial full-quality frame with the requested renderer
        _read_until(master, r"\[null_renderer\]", proc=proc)
        # '-' cycles back to the rasterizer (registry order); the terminal
        # title carries the status line (main.cpp:154-163 analogue)
        os.write(master, b"-")
        _read_until(master, r"(?s)\x1b\]0;rt - .*scene\.toml - rasterizer\x07"
                            r".*\[rasterizer\]", proc=proc)
        # movement: a low-res frame now, the full-quality one ~0.5 s later
        os.write(master, b"w")
        _read_until(master, r"\[rasterizer\]", proc=proc)
        # hot reload via the mtime poll: a confirmation prompt, 'y' reloads
        # with the camera kept
        scene_file.write_text(SCENE.replace("'red'", "'blue'"))
        os.utime(scene_file, (time.time() + 2, time.time() + 2))
        _read_until(master, r"reload\? \[y/n\]", proc=proc)
        os.write(master, b"y")
        _read_until(master, r"\[rasterizer\].*scene\.toml", proc=proc)
        # 'r' reload, let the redraw land, then quit
        os.write(master, b"r")
        _read_until(master, r"\[rasterizer\]", proc=proc)
        time.sleep(0.5)
        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        _close(master, proc)


def test_viewer_low_res_frames_and_kept_camera(tmp_path):
    """While the camera moves the frame is the rasterizer's at x0.1 of the
    size under RT_TPU_DEBUG (200x100 -> 20x10: 20 preview columns), then
    the full 200x100 (100 columns); a reload keeps the moved camera."""
    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)
    master, proc = _viewer(scene_file, _child_env(RT_TPU_DEBUG="1", RT_VIEWER_DEBUG="1"),
                           size=(200, 100))
    pos_re = re.compile(r"cam pos=\((-?\d+\.\d+),(-?\d+\.\d+),(-?\d+\.\d+)\)")

    def settled(buf):
        """A low-res frame (20 preview columns) then a full one (100) in ``buf``."""
        cols = [f.split("\n")[0].count("▀") for f in buf.split("\x1b[H\x1b[2J")[1:]]
        return 20 in cols and 100 in cols[cols.index(20):]

    try:
        buf = _read_until(master, r"\[null_renderer\] 200x100.*\n.*cam pos=.*\n", proc=proc)
        pos0 = pos_re.findall(buf)[-1]
        os.write(master, b"-")
        _read_until(master, r"\[rasterizer\]", proc=proc)
        os.write(master, b"w")
        buf = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not settled(buf):
            buf += _read_until(master, r"\[rasterizer\].*\n.*cam pos=.*\n", proc=proc)
        assert settled(buf), buf[-400:]
        pos1 = pos_re.findall(buf)[-1]
        assert pos1 != pos0
        scene_file.write_text(SCENE.replace("'red'", "'blue'"))
        os.utime(scene_file, (time.time() + 2, time.time() + 2))
        _read_until(master, r"reload\? \[y/n\]", proc=proc)
        os.write(master, b"y")
        buf = _read_until(master, r"\[rasterizer\].*\n.*cam pos=.*\n", proc=proc)
        assert pos_re.findall(buf)[-1] == pos1
        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        _close(master, proc)


def test_viewer_mouse_look_and_resize_pty(tmp_path):
    """RMB drag-look via SGR mouse reporting + SIGWINCH-driven resize
    (main.cpp:208-232, window.cpp:198-203)."""
    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)
    master, proc = _viewer(scene_file, _child_env(RT_VIEWER_DEBUG="1"), rows_cols=(20, 60))
    fwd_re = re.compile(r"fwd=\((-?\d+\.\d+),(-?\d+\.\d+),(-?\d+\.\d+)\)")
    try:
        # the first frame, its status line and its camera HUD (one read: a
        # loaded host may deliver them in one chunk)
        buf = _read_until(master, r"\[null_renderer\] 48x28[^\n]*\n[^\n]*fwd=\([^)]*\)",
                          proc=proc)
        # mouse reporting is enabled (DECSET 1002/1006)
        assert "\x1b[?1002h\x1b[?1006h" in buf
        first = fwd_re.search(buf)
        assert first is not None, f"no cam HUD in {buf[-400:]!r}"
        fwd0 = first.groups()

        # RMB press at (60,5), drag left to (20,5) in four moves, release:
        # each move adds 10 * 0.1 = 1 rad of yaw, applied x the frame's dt
        # on the next loop (spaced out, so that a loaded host does not run
        # them in back-to-back loops of a tiny dt)
        os.write(master, b"\x1b[<2;60;5M")
        for x in (50, 40, 30, 20):
            time.sleep(0.25)
            os.write(master, b"\x1b[<34;%d;5M" % x)
        time.sleep(0.4)
        os.write(master, b"\x1b[<2;20;5m")

        deadline = time.monotonic() + 60
        rotated = False
        while time.monotonic() < deadline and not rotated:
            buf += _read_until(master, r"fwd=", proc=proc)
            rotated = any(m.groups() != fwd0 for m in fwd_re.finditer(buf))
        assert rotated, f"camera never rotated; HUD tail: {buf[-400:]!r}"

        # shrink the terminal; after the 0.3 s debounce the render size is
        # rebuilt from the cell grid: (2*(30-2), 4*(12-3)) = 56x36
        fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", 12, 30, 0, 0))
        proc.send_signal(signal.SIGWINCH)
        _read_until(master, r"\[null_renderer\] 56x36", proc=proc)

        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        _close(master, proc)


def test_cli_interactive_and_quit(tmp_path):
    """``--interactive`` starts the viewer before the renderer is resolved
    and passes ``--device``; 'q' quits with rc 0."""
    import pty

    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)
    master, slave = pty.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt_tpu_torch.cli", "--interactive", "--scene", str(scene_file),
         "-r", "rast", "--size", "40x20", "--device", "cpu"],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL, env=_child_env(), cwd=REPO,
        close_fds=True)
    os.close(slave)
    try:
        _read_until(master, r"\[rasterizer\] 40x20", proc=proc)
        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        _close(master, proc)


def test_cli_watch_rerenders(tmp_path):
    scene_file = tmp_path / "watched.toml"
    scene_file.write_text(SCENE)
    out = tmp_path / "out.png"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "rt_tpu_torch.cli", "--scene", str(scene_file),
         "--renderer", "rasterizer", "--size", "32x24", "--out", str(out), "--watch",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_child_env(), cwd=REPO)
    fd = proc.stdout.fileno()
    try:
        _read_until(fd, r"watching for changes", proc=proc)
        mtime0 = out.stat().st_mtime

        # a broken edit: error logged, previous scene kept, no exit
        scene_file.write_text("materials = [ { type = 'nope' } ]\n")
        os.utime(scene_file, (time.time() + 2, time.time() + 2))
        _read_until(fd, r"error:.*material_type", proc=proc)
        assert proc.poll() is None

        # a good edit: automatic re-render to the same output file
        scene_file.write_text(SCENE.replace("0.5", "0.7"))
        os.utime(scene_file, (time.time() + 4, time.time() + 4))
        # one read: a loaded host may deliver both lines in one chunk
        _read_until(fd, r"(?s)reloaded.*rendered 32x24", proc=proc)
        # the PNG write lands before the "rendered" log line in the port
        assert out.stat().st_mtime != mtime0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
