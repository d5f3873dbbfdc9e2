"""Terminal viewer: the window/event-loop layer without SDL (port of
``rt_tpu.viewer``).

The reference hosts renderers in an SDL window with FPS-style controls and
a low-res preview while the camera moves (window.cpp, main.cpp:177-322).
This module renders to the terminal with ANSI truecolor half-blocks and
reproduces the interaction model:

* WASD + space/c to move; yaw/pitch via RMB drag-look (SGR mouse
  reporting, DECSET 1002/1006 — the terminal reproduction of
  main.cpp:208-232's ``yaw_delta += dx * 0.1`` applied scaled by the
  frame delta, main.cpp:266-280) or arrow keys; q/ESC to quit.
* Terminal resizes (SIGWINCH) rebuild the render size after a 0.3 s
  debounce — the reference's back-buffer rebuild on window resize
  (window.cpp:198-203).
* '+'/'-' cycle the registered renderers (main.cpp:181-191).
* 'r' reloads the scene; the file's mtime is also polled every 0.5 s
  (main.cpp:235-254); a failed reload keeps the previous scene
  (main.cpp:127-132).  The camera pose is preserved across reloads
  (main.cpp:110-117).
* While moving, frames come from the rasterizer at reduced resolution;
  0.5 s after the last movement a full-quality frame is rendered
  (main.cpp:305-311, window.cpp:54-64's low-res back buffer).

The scene and its camera stay on the host; each frame renders on
``device`` (default the card).
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

__all__ = ["ansi_preview", "print_preview", "interactive"]


def ansi_preview(img, max_width: int = 100) -> str:
    """Render a float (H, W, 3) image as ANSI truecolor half-blocks.

    Each character cell shows two vertically stacked pixels (▀ with
    foreground = upper pixel, background = lower pixel).  A torch tensor
    is moved to the host first.
    """
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    h, w = img.shape[:2]
    step = max(1, -(-w // max_width))
    small = img[::step, ::step, :3]
    if small.shape[0] % 2:
        small = np.concatenate([small, np.zeros((1,) + small.shape[1:], small.dtype)])
    q = np.clip(small * 255.99999, 0, 255).astype(np.int32)
    lines = []
    for y in range(0, q.shape[0], 2):
        row = []
        for x in range(q.shape[1]):
            tr, tg, tb = q[y, x]
            br, bg, bb = q[y + 1, x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def print_preview(img, max_width: int = 100) -> None:
    print(ansi_preview(img, max_width))


class _RawTerm:
    """cbreak-mode stdin for single-key reads (no-op when not a tty).

    ``mouse=True`` additionally enables SGR mouse reporting (DECSET 1002 =
    button-event tracking incl. drag motion, 1006 = SGR extended coords) so
    RMB drag-look works like the reference's SDL mouse path
    (main.cpp:208-232).  Mouse events come back as
    ``("mouse", button_code, col, row, is_press)`` tuples."""

    MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
    MOUSE_OFF = "\x1b[?1006l\x1b[?1002l"

    def __init__(self, mouse: bool = False):
        self.mouse = mouse
        # raw byte buffer: escape sequences arrive as several bytes and a
        # buffered sys.stdin.read(1) would swallow them past select()'s
        # visibility — all reads go through os.read + this buffer
        self.buf = b""

    def __enter__(self):
        self.enabled = sys.stdin.isatty()
        if self.enabled:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.old = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
            if self.mouse:
                sys.stdout.write(self.MOUSE_ON)
                sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import termios

            if self.mouse:
                sys.stdout.write(self.MOUSE_OFF)
                sys.stdout.flush()
            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def _next_byte(self, timeout: float):
        """One byte from the internal buffer, refilled via os.read."""
        if not self.buf:
            r, _, _ = select.select([self.fd], [], [], timeout)
            if not r:
                return None
            try:
                self.buf = os.read(self.fd, 4096)
            except OSError:
                return None
            if not self.buf:
                return None
        b, self.buf = self.buf[:1], self.buf[1:]
        return b.decode("latin-1")

    def _read_csi(self):
        """Read the remainder of an ESC[-sequence (params + final byte)."""
        seq = ""
        while len(seq) < 24:
            c = self._next_byte(0.01)
            if c is None:
                break
            seq += c
            if c.isalpha() or c == "~":
                break
        return seq

    def get_key(self, timeout: float = 0.05):
        if not self.enabled:
            time.sleep(timeout)
            return None
        ch = self._next_byte(timeout)
        if ch is None:
            return None
        if ch != "\x1b":
            return ch
        lead = self._next_byte(0.01)
        if lead is None:
            return "esc"
        if lead != "[":
            return "esc"
        seq = self._read_csi()
        if seq and seq[0] == "<" and seq[-1] in "Mm":
            # SGR mouse: ESC [ < Cb ; Cx ; Cy (M=press/motion, m=release)
            try:
                cb, cx, cy = (int(v) for v in seq[1:-1].split(";"))
            except ValueError:
                return None
            return ("mouse", cb, cx, cy, seq[-1] == "M")
        return {"A": "up", "B": "down", "C": "right", "D": "left"}.get(seq, "esc")


def _kick(render, raster, scene, size, key, *, spp, low_res: bool, low_res_scale: float, device):
    """Start one frame: the rasterizer at ``low_res_scale`` of ``size``
    while the camera moves, else ``render``.  Returns the frame on
    ``device``; whether the device is still rendering it when this
    returns depends on the route (README "Viewer")."""
    if low_res:
        small = (max(int(size[0] * low_res_scale), 16), max(int(size[1] * low_res_scale), 9))
        return raster(scene, small, key, device=device)
    opts = {} if spp is None else {"spp": spp}
    return render(scene, size, key, device=device, **opts)


def interactive(
    scene_path: str = "",
    renderer_name: str = "mg",
    *,
    size: tuple[int, int] = (192, 108),
    spp: int | None = None,
    seed: int = 0,
    move_speed: float = 1.5,
    turn_speed: float = 0.15,
    low_res_scale: float | None = None,
    confirm_reload: bool = True,
    mouse_sensitivity: float = 0.1,
    follow_resize: bool = True,
    device="cuda",
):
    """Interactive terminal loop (the reference's `run()` without SDL).

    ``confirm_reload``: when the scene file changes on disk, show a
    reload-confirmation prompt instead of reloading silently — the
    terminal analogue of the reference's ImGui "scene file has changed,
    reload?" dialog (main.cpp:251-263); 'y' (or 'r') reloads with the
    camera preserved, 'n' dismisses until the next change.

    ``low_res_scale``: preview-buffer scale while the camera moves.  The
    default follows the reference's two compile-mode tiers (×0.33 release /
    ×0.1 debug, window.cpp:54-64): 0.33, or 0.1 when ``RT_TPU_DEBUG`` is
    set in the environment (the runtime analogue of a debug build).

    ``mouse_sensitivity``: radians of yaw/pitch delta per dragged terminal
    cell; the accumulated delta is applied scaled by the frame delta-time,
    exactly the reference's ``yaw_delta += dx * 0.1`` →
    ``rotate_yaw(yaw_delta * delta_time)`` chain (main.cpp:225-226, 266-280).

    ``follow_resize``: rebuild the render size 0.3 s after the last
    SIGWINCH, the reference's debounced back-buffer rebuild
    (window.cpp:198-203).

    ``device``: where the frames render ("cuda", or "cpu" for the kernels'
    plain versions)."""
    import dataclasses
    import signal

    import torch

    import rt_tpu_torch
    from rt_tpu_torch import renderer as registry
    from rt_tpu_torch.camera import rotate_pitch, rotate_yaw

    if low_res_scale is None:
        low_res_scale = 0.1 if os.environ.get("RT_TPU_DEBUG") else 0.33

    def load():
        if scene_path:
            return rt_tpu_torch.load(scene_path)
        return rt_tpu_torch.load_first_available()

    scene = load()
    names = [d.name for d in registry.all_renderers()]
    try:
        r_idx = names.index(registry.find_by_name_fuzzy(renderer_name).name)
    except AttributeError:
        raise SystemExit(f"no known renderer with name '{renderer_name}'")
    render = registry.all_renderers()[r_idx].create()
    raster = registry.create("rasterizer")
    key = rt_tpu_torch.rng.make_key(seed)

    last_move = 0.0
    last_mtime_check = 0.0
    mtime = os.path.getmtime(scene.path) if scene.path else None
    dirty = True
    full_quality_pending = False
    reload_prompt = False
    # RMB drag-look state (main.cpp:199-232)
    mouse_dragging = False
    last_mouse = (0, 0)
    yaw_delta = 0.0
    pitch_delta = 0.0
    prev_time = time.monotonic()
    debug_hud = bool(os.environ.get("RT_VIEWER_DEBUG"))

    # debounced resize (window.cpp:198-203): the handler only timestamps;
    # the loop rebuilds the size 0.3 s after the last SIGWINCH
    resize_at = [0.0]
    if follow_resize and hasattr(signal, "SIGWINCH"):
        try:
            signal.signal(signal.SIGWINCH,
                          lambda *_: resize_at.__setitem__(0, time.monotonic()))
        except ValueError:  # not the main thread
            pass

    def terminal_render_size():
        """Map the terminal cell grid to a render size: the half-block
        preview uses ~W/2 columns and ~H/4 rows (2x2 px per cell after the
        downsample step), minus 3 rows of status text."""
        try:
            ts = os.get_terminal_size(sys.stdout.fileno())
        except OSError:
            return None
        w = max(32, 2 * (ts.columns - 2))
        h = max(16, 4 * max(ts.lines - 3, 4))
        return (w - w % 2, h - h % 2)

    def update_title():
        # terminal-title status line (the reference's window title carries
        # "rt - <scene> - <renderer>", main.cpp:154-163; OSC 0 is the
        # terminal analogue)
        parts = ["rt"]
        if scene.path:
            parts.append(scene.path)
        parts.append(names[r_idx])
        sys.stdout.write("\x1b]0;" + " - ".join(parts) + "\x07")
        sys.stdout.flush()

    # Double buffering, the reference's dirty/present split
    # (window.cpp:213-224): kick() starts frame N and returns its device
    # tensor, and while the device renders it present() copies frame N-1
    # to the host (.cpu(), which waits for that frame) and draws it.  The
    # overlap holds only where a route returns before its frame is done.
    def kick(low_res: bool):
        return _kick(render, raster, scene, size, key, spp=spp, low_res=low_res,
                     low_res_scale=low_res_scale, device=device)

    def present(dev_img):
        img = dev_img.cpu().numpy()
        sys.stdout.write("\x1b[H\x1b[2J")
        print_preview(img, max_width=size[0] // 2)
        update_title()
        print(f"[{names[r_idx]}] {size[0]}x{size[1]} {scene.path or '<default>'}  "
              "wasd/space/c move, RMB-drag/arrows look, +/- renderer, "
              "r reload, q quit")
        if debug_hud:
            fwd = scene.camera.forward.numpy()
            pos = scene.camera.position.numpy()
            print(f"cam pos=({pos[0]:.3f},{pos[1]:.3f},{pos[2]:.3f}) "
                  f"fwd=({fwd[0]:.4f},{fwd[1]:.4f},{fwd[2]:.4f})")
        if reload_prompt:
            print("scene file has changed on disk — reload? [y/n]")

    pending = None  # in-flight device frame (double buffer)

    with _RawTerm(mouse=True) as term:
        while True:
            now = time.monotonic()
            # frame delta, clamped like the reference (main.cpp's
            # std::min(dt, 0.1f) via window.cpp:205)
            dt = min(now - prev_time, 0.1)
            prev_time = now

            # apply accumulated drag-look deltas scaled by dt
            # (main.cpp:266-280)
            if mouse_dragging and (yaw_delta != 0.0 or pitch_delta != 0.0):
                cam = scene.camera
                if yaw_delta != 0.0:
                    cam = dataclasses.replace(
                        cam, rotation=rotate_yaw(cam.rotation, yaw_delta * dt))
                if pitch_delta != 0.0:
                    cam = dataclasses.replace(
                        cam, rotation=rotate_pitch(cam.rotation, pitch_delta * dt))
                yaw_delta = 0.0
                pitch_delta = 0.0
                scene = dataclasses.replace(scene, camera=cam)
                last_move = now
                dirty = True

            # debounced resize -> rebuild the render size
            if resize_at[0] and now - resize_at[0] > 0.3:
                resize_at[0] = 0.0
                new_size = terminal_render_size()
                if new_size and new_size != size:
                    size = new_size
                    dirty = True
            if dirty:
                low = (now - last_move) < 0.5 and last_move > 0
                nxt = kick(low)
                if pending is not None:
                    present(pending)   # draw N-1 while N renders on device
                pending = nxt
                full_quality_pending = low
                dirty = False
            elif full_quality_pending and (now - last_move) >= 0.5:
                nxt = kick(False)
                if pending is not None:
                    present(pending)
                pending = nxt
                full_quality_pending = False
            elif pending is not None:
                # nothing newer queued: show the in-flight frame
                present(pending)
                pending = None

            # scene hot-reload poll (main.cpp:235-249)
            if scene.path and now - last_mtime_check > 0.5:
                last_mtime_check = now
                try:
                    m = os.path.getmtime(scene.path)
                except OSError:
                    m = mtime
                if m != mtime:
                    mtime = m
                    if confirm_reload:
                        reload_prompt = True
                        dirty = True
                    else:
                        try:
                            cam = scene.camera
                            scene = load()
                            scene = dataclasses.replace(scene, camera=cam)
                            dirty = True
                        except Exception as ex:  # keep the previous scene
                            print(f"error: {ex}")

            k = term.get_key()
            if k is None:
                continue
            if isinstance(k, tuple) and k[0] == "mouse":
                _, cb, cx, cy, press = k
                btn = cb & 3
                motion = bool(cb & 32)
                if motion and mouse_dragging:
                    # accumulate like main.cpp:225-226 (0.1 rad per cell);
                    # leftward drag = positive yaw, downward = positive
                    # pitch, matching the camera.rotate_* conventions
                    yaw_delta += (last_mouse[0] - cx) * mouse_sensitivity
                    pitch_delta += (last_mouse[1] - cy) * mouse_sensitivity
                    last_mouse = (cx, cy)
                elif btn == 2 and press and not motion:  # RMB down
                    mouse_dragging = True
                    last_mouse = (cx, cy)
                elif btn == 2 and not press:  # RMB up
                    mouse_dragging = False
                continue
            cam = scene.camera
            moved = False
            if k in ("q", "esc"):
                break
            elif k in "wasd c":
                fwd, rgt = cam.forward, cam.right
                up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
                delta = {"w": fwd, "s": -fwd, "a": -rgt, "d": rgt,
                         " ": up, "c": -up}.get(k)
                if delta is not None:
                    cam = dataclasses.replace(cam, position=cam.position + move_speed * delta)
                    moved = True
            elif k in ("left", "right"):
                ang = turn_speed if k == "left" else -turn_speed
                cam = dataclasses.replace(cam, rotation=rotate_yaw(cam.rotation, ang))
                moved = True
            elif k in ("up", "down"):
                ang = turn_speed if k == "up" else -turn_speed
                cam = dataclasses.replace(cam, rotation=rotate_pitch(cam.rotation, ang))
                moved = True
            elif k == "+":
                r_idx = (r_idx + 1) % len(names)
                render = registry.all_renderers()[r_idx].create()
                dirty = True
            elif k == "-":
                r_idx = (r_idx - 1) % len(names)
                render = registry.all_renderers()[r_idx].create()
                dirty = True
            elif k == "r" or (reload_prompt and k in ("y", "Y")):
                reload_prompt = False
                try:
                    c = scene.camera
                    scene = dataclasses.replace(load(), camera=c)
                    dirty = True
                except Exception as ex:  # keep the previous scene
                    print(f"error: {ex}")
            elif reload_prompt and k in ("n", "N"):
                reload_prompt = False
                dirty = True
            if moved:
                scene = dataclasses.replace(scene, camera=cam)
                last_move = time.monotonic()
                dirty = True
    print("bye")
