"""Terminal image viewer: ANSI truecolor half-block rendering.

Copy of `nori_tpu/tui.py` (numpy, PIL, termios) with its imports
rewritten.

The reference's NoriScreen (src/gui.cpp:19-132) is a nanogui window
that shows the film live while rendering, with an exposure slider
feeding a sRGB tonemap shader (src/gui.cpp:36-42, scale = 2^exposure).
A compute host has no display server, but every session has a
terminal: this module renders the film into 24-bit ANSI color using
U+2580 half blocks (each character cell carries two vertically stacked
pixels: foreground color = top, background = bottom), which modern
terminals display over plain SSH.

Three surfaces:
  ansi_frame(img, cols, rows, exposure)  pure string renderer
  live_view(img, status)                 in-place redraw per chunk
                                         (the live render screen)
  interactive(img, save_base)            key loop: -/+ exposure slider
                                         equivalent, s saves PNG,
                                         q quits (the EXR viewer)
"""

from __future__ import annotations

import shutil
import sys

import numpy as np

_CSI = "\x1b["
_RESET = _CSI + "0m"
_HALF = "▀"           # upper half block


def _resize_area(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Downscale (H, W, 3) float RGB with PIL's box/bilinear filter
    (good enough for a preview; avoids hand-rolled reduceat bins)."""
    from PIL import Image

    h, w = img.shape[:2]
    if (w, h) == (out_w, out_h):
        return img
    chans = []
    filt = Image.BOX if (out_w < w or out_h < h) else Image.BILINEAR
    for c in range(3):
        im = Image.fromarray(np.ascontiguousarray(
            img[:, :, c], dtype=np.float32), mode="F")
        chans.append(np.asarray(im.resize((out_w, out_h), filt)))
    return np.stack(chans, axis=-1)


def frame_pixels(img: np.ndarray, cols: int, rows: int,
                 exposure: float = 0.0) -> np.ndarray:
    """Tonemapped uint8 pixel grid fitted to a cols x rows cell
    terminal: returns (2*r, c, 3) with c <= cols, 2*r <= 2*rows.

    A cell is one column wide and two half-block pixels tall, and
    terminal cells are ~1:2 wide:tall, so half-pixels are close to
    square: uniform scale fitting preserves aspect like the GUI
    window's glViewport fit.
    """
    from nori_tpu_torch.core.color import np_to_srgb

    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    scale = min(cols / w, (2 * rows) / h, 1.0)
    out_w = max(1, int(w * scale))
    out_h = max(2, int(h * scale) & ~1)      # even: full half-block cells
    img = _resize_area(img, out_w, out_h)
    srgb = np_to_srgb(np.clip(img * (2.0 ** exposure), 0.0, None))
    return np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def ansi_frame(img: np.ndarray, cols: int, rows: int,
               exposure: float = 0.0) -> str:
    """Render linear RGB to an ANSI truecolor half-block string of at
    most `rows` lines x `cols` columns (newline-separated, colors
    reset at each line end)."""
    px = frame_pixels(img, cols, rows, exposure)
    top, bot = px[0::2], px[1::2]
    lines = []
    for r in range(top.shape[0]):
        parts = []
        for c in range(top.shape[1]):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            parts.append(f"{_CSI}38;2;{tr};{tg};{tb}m"
                         f"{_CSI}48;2;{br};{bg};{bb}m{_HALF}")
        lines.append("".join(parts) + _RESET)
    return "\n".join(lines)


def _term_size(reserve_rows: int = 2):
    size = shutil.get_terminal_size(fallback=(100, 40))
    return size.columns, max(4, size.lines - reserve_rows)


def live_view(img: np.ndarray, status: str = "",
              exposure: float = 0.0, out=None) -> None:
    """Redraw the image in place (cursor-home, no scrollback spam) —
    the per-chunk live render display (src/gui.cpp:19-132)."""
    out = out or sys.stdout
    cols, rows = _term_size()
    frame = ansi_frame(img, cols, rows, exposure)
    out.write(_CSI + "H" + _CSI + "2J" + frame + "\n"
              + status[:cols] + _CSI + "0K\n")
    out.flush()


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return rx @ ry


def point_cloud_image(points: np.ndarray, width: int, height: int,
                      yaw: float = 0.0, pitch: float = 0.0,
                      zoom: float = 1.0, lines=None) -> np.ndarray:
    """Orthographic point-cloud render: (N, 2|3) points rotated by
    (yaw, pitch), density-splatted white-on-black, with optional
    warped-grid polylines drawn in red — the warptest arcball scene
    (src/warptest.cpp:73-119) as a linear RGB image.
    """
    def to3(a):
        a = np.asarray(a, dtype=np.float64)
        if a.shape[1] == 2:
            a = np.concatenate([a, np.zeros((a.shape[0], 1))], axis=1)
        return a

    pts = to3(points)
    lines3 = [to3(ln) for ln in (lines or [])]
    allp = np.concatenate([pts] + lines3) if lines3 else pts
    center = 0.5 * (allp.min(axis=0) + allp.max(axis=0))
    radius = max(float(np.max(np.linalg.norm(allp - center, axis=1))),
                 1e-9)
    rot = _rotation(yaw, pitch)

    def to_px(p):
        q = (p - center) @ rot.T
        s = zoom * 0.45 * min(width, height) / radius
        xi = np.round(q[:, 0] * s + width / 2).astype(int)
        yi = np.round(height / 2 - q[:, 1] * s).astype(int)
        ok = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        return xi[ok], yi[ok]

    img = np.zeros((height, width, 3), dtype=np.float32)
    dens = np.zeros((height, width), dtype=np.float32)
    xi, yi = to_px(pts)
    np.add.at(dens, (yi, xi), 1.0)
    peak = np.percentile(dens[dens > 0], 95.0) if dens.any() else 1.0
    img[:, :, :] = np.minimum(dens / max(peak, 1e-9), 1.0)[:, :, None]
    for ln in lines3:
        # densify segments so rotated lines stay connected
        ln = np.concatenate(
            [np.linspace(a, b, 8) for a, b in zip(ln[:-1], ln[1:])])
        xi, yi = to_px(ln)
        img[yi, xi] = np.array([1.0, 0.15, 0.15], dtype=np.float32)
    return img


def arcball(points: np.ndarray, lines=None, title: str = "",
            out=None) -> None:
    """Interactive terminal point-cloud viewer — the warptest arcball
    (src/warptest.cpp:73-119): arrow keys / hjkl rotate, +/- zoom,
    0 resets, q/ESC quits.  Non-TTY: prints one frame and returns."""
    out = out or sys.stdout
    yaw, pitch, zoom = 0.6, 0.45, 1.0

    def draw():
        cols, rows = _term_size()
        img = point_cloud_image(points, cols, 2 * rows,
                                yaw=yaw, pitch=pitch, zoom=zoom,
                                lines=lines)
        frame = ansi_frame(img, cols, rows)
        out.write(_CSI + "H" + _CSI + "2J" + frame + "\n"
                  + f"{title}  yaw {yaw:+.2f} pitch {pitch:+.2f} "
                  f"zoom {zoom:.2f}  [arrows/hjkl rotate, +/- zoom, "
                  f"0 reset, q quit]" + _CSI + "0K\n")
        out.flush()

    if not (hasattr(sys.stdin, "fileno") and sys.stdin.isatty()):
        draw()
        return

    import termios
    import tty

    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    out.write(_CSI + "?1049h" + _CSI + "?25l")
    try:
        tty.setcbreak(fd)
        step = 0.15
        while True:
            draw()
            ch = sys.stdin.read(1)
            if ch == "\x1b":                  # ESC or arrow sequence
                import select

                if select.select([fd], [], [], 0.05)[0]:
                    seq = sys.stdin.read(2)
                    ch = {"[A": "k", "[B": "j",
                          "[C": "l", "[D": "h"}.get(seq, "")
                else:
                    break
            if ch in ("q", "Q"):
                break
            elif ch == "h":
                yaw -= step
            elif ch == "l":
                yaw += step
            elif ch == "k":
                pitch -= step
            elif ch == "j":
                pitch += step
            elif ch in ("+", "="):
                zoom *= 1.25
            elif ch in ("-", "_"):
                zoom /= 1.25
            elif ch == "0":
                yaw, pitch, zoom = 0.6, 0.45, 1.0
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        out.write(_CSI + "?25h" + _CSI + "?1049l")
        out.flush()


def interactive(img: np.ndarray, save_base: str = "nori_view",
                out=None) -> float:
    """Interactive viewer: -/+ (or =/_) step exposure by half a stop
    like the GUI slider, 0 resets, s writes <save_base>.png at the
    current exposure, q/ESC quits.  Returns the final exposure.

    Falls back to a single printed frame when stdin isn't a TTY.
    """
    out = out or sys.stdout
    exposure = 0.0
    if not (hasattr(sys.stdin, "fileno") and sys.stdin.isatty()):
        cols, rows = _term_size()
        out.write(ansi_frame(img, cols, rows, exposure) + "\n")
        out.flush()
        return exposure

    import termios
    import tty

    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    out.write(_CSI + "?1049h" + _CSI + "?25l")     # alt screen, no cursor
    try:
        tty.setcbreak(fd)
        msg = ""
        while True:
            live_view(img, status=(
                f"exposure {exposure:+.1f}  [-/+ adjust, 0 reset, "
                f"s save, q quit] {msg}"), exposure=exposure, out=out)
            ch = sys.stdin.read(1)
            msg = ""
            if ch in ("q", "Q", "\x1b"):
                break
            elif ch in ("+", "="):
                exposure += 0.5
            elif ch in ("-", "_"):
                exposure -= 0.5
            elif ch == "0":
                exposure = 0.0
            elif ch in ("s", "S"):
                from nori_tpu_torch.bitmap import write_png

                path = f"{save_base}.png"
                write_png(path, np.asarray(img) * (2.0 ** exposure))
                msg = f"saved {path}"
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        out.write(_CSI + "?25h" + _CSI + "?1049l")
        out.flush()
    return exposure
