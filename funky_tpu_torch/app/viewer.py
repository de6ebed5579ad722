"""Interactive terminal viewer — the remaining event-loop surface (a copy
of funky_tpu/app/viewer.py over the port's FrameDriver; pure Python and
numpy).

The reference's winit window loop (main.rs:470-567) handles ESC exit
(main.rs:494-497), F3 debug-UI toggle (505-512), F11 fullscreen toggle
(513-520), minimized windows (543-552: redraws skipped while minimized),
and egui keyboard consumption (475-486: keys go to the UI instead of the
camera while egui wants them). This headless framework renders to a
terminal instead of a swapchain: frames stream as 24-bit ANSI half-block
cells, and the same event behaviors map onto terminal keys:

    ESC        exit                         w/a/s/d/q/e  camera move
    3          toggle debug panel (F3)      arrows       yaw / pitch
    f          fullscreen toggle (F11)      z/x          FOV zoom
    n          minimize/restore             TAB          UI focus toggle
    (UI focus) j/k select widget, space toggle, +/- adjust — keys are
               CONSUMED by the panel, not the camera (main.rs:475-486)

Pointer events (the reference routes mouse input through egui,
main.rs:475-486, and consumes the wheel for FOV zoom, main.rs:534-542)
arrive as xterm SGR-1006 escape sequences (ESC [ < b ; x ; y M/m): left
click hits the debug panel's widgets, the wheel zooms the camera FOV.
`run()` enables terminal mouse reporting; `feed()` accepts the raw
sequences, so tests drive clicks without a tty.

`TerminalViewer.feed()` is the event entry point and is fully scriptable
(tests drive it without a tty); `run()` wires it to a raw-mode stdin.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Iterable, Optional

import numpy as np

from .camera import Keys
from .ui import UiChanges

_CAMERA_KEYS = {
    "w": Keys.W, "a": Keys.A, "s": Keys.S, "d": Keys.D,
    "q": Keys.Q, "e": Keys.E, "z": Keys.Z, "x": Keys.X,
    "\x1b[A": Keys.UP, "\x1b[B": Keys.DOWN,
    "\x1b[C": Keys.RIGHT, "\x1b[D": Keys.LEFT,
}

# Panel widget ranges (egui_integration.rs:137-171: scale log slider
# 0.001-0.5, softness 0.5-8, three toggles).
_WIDGETS = (
    ("gltf_scale", "log", 0.001, 0.5),
    ("shadow_softness", "lin", 0.5, 8.0),
    ("debug_cascades", "bool", None, None),
    ("use_pcss", "bool", None, None),
    ("use_shadow_taa", "bool", None, None),
)


@dataclasses.dataclass
class ViewerState:
    running: bool = True
    minimized: bool = False
    fullscreen: bool = False
    ui_focus: bool = False
    focus_idx: int = 0


class TerminalViewer:
    """Drives a FrameDriver from key events and renders ANSI previews."""

    def __init__(self, driver, cols: int = 96,
                 fullscreen_size: Optional[tuple] = None) -> None:
        self.driver = driver
        self.cols = cols
        self._windowed = (driver.cfg.width, driver.cfg.height)
        self._fullscreen = fullscreen_size or (
            driver.cfg.width * 2, driver.cfg.height * 2)
        self.state = ViewerState()

    # -- event handling ------------------------------------------------------
    def feed(self, events: Iterable[str]) -> set:
        """Process key events; returns the camera key set for this frame.
        Events are terminal key strings (single chars or escape
        sequences)."""
        st = self.state
        keys = set()
        for ev in events:
            if ev == "\x1b":                      # ESC (main.rs:494-497)
                st.running = False
            elif ev == "3":                       # F3 (main.rs:505-512)
                self.driver.toggle_ui()
            elif ev == "f":                       # F11 (main.rs:513-520)
                st.fullscreen = not st.fullscreen
                w, h = self._fullscreen if st.fullscreen else self._windowed
                self.driver.resize(w, h)
            elif ev == "n":                       # minimize (main.rs:543-552)
                st.minimized = not st.minimized
            elif ev == "\t":                      # egui focus toggle
                st.ui_focus = not st.ui_focus
            elif ev.startswith("\x1b[<"):         # SGR-1006 mouse report
                self._mouse(ev)
            elif st.ui_focus and self.driver.ui_visible:
                # Consumed by the panel (main.rs:475-486): never reaches
                # the camera.
                self._ui_key(ev)
            elif ev in _CAMERA_KEYS:
                keys.add(_CAMERA_KEYS[ev])
        return keys

    # -- pointer events --------------------------------------------------------
    def _cell_to_pixel(self, cx: int, cy: int) -> tuple:
        """Terminal cell (1-based col, row) -> framebuffer pixel, inverting
        render_ansi's sampling grid (each cell shows 2 vertical pixels)."""
        w, h = self.driver.cfg.width, self.driver.cfg.height
        cols = min(self.cols, w)
        rows = max(2, int(cols * (h / w) * 0.5) * 2)
        px = (cx - 1) * (w - 1) / max(cols - 1, 1)
        py = (2 * (cy - 1)) * (h - 1) / max(rows - 1, 1)
        return px, py

    def _mouse(self, ev: str) -> None:
        """SGR-1006 sequence ESC [ < Cb ; Cx ; Cy (M=press | m=release):
        wheel -> FOV zoom (main.rs:534-542), left press -> egui hit test
        (main.rs:475-486)."""
        from .camera import apply_scroll_zoom

        if len(ev) < 5 or ev[-1] not in "Mm":
            return
        try:
            cb, cx, cy = (int(p) for p in ev[3:-1].split(";"))
        except ValueError:
            return
        press = ev[-1] == "M"
        if cb in (64, 65) and press:              # wheel up / down
            self.driver.camera = apply_scroll_zoom(
                self.driver.camera, 1.0 if cb == 64 else -1.0)
        elif cb == 0 and press:                   # left button press
            if self.driver.ui is not None and self.driver.ui_visible:
                px, py = self._cell_to_pixel(cx, cy)
                changes = self.driver.ui.hit(px, py, self.driver.ui_data())
                self.driver.apply_ui_changes(changes)

    def _ui_key(self, ev: str) -> None:
        st = self.state
        if ev == "j":
            st.focus_idx = (st.focus_idx + 1) % len(_WIDGETS)
            return
        if ev == "k":
            st.focus_idx = (st.focus_idx - 1) % len(_WIDGETS)
            return
        name, kind, lo, hi = _WIDGETS[st.focus_idx]
        data = self.driver.ui_data()
        changes = UiChanges()
        if kind == "bool":
            if ev == " ":
                setattr(changes, name, not getattr(data, name))
        elif ev in "+-":
            val = getattr(data, name)
            if kind == "log":
                step = math.exp((math.log(hi) - math.log(lo)) / 20.0)
                val = val * step if ev == "+" else val / step
            else:
                step = (hi - lo) / 20.0
                val = val + step if ev == "+" else val - step
            setattr(changes, name, min(max(val, lo), hi))
        self.driver.apply_ui_changes(changes)

    # -- frame loop ----------------------------------------------------------
    def step(self, events: Iterable[str] = (), dt: float = 0.016):
        """One event-loop turn: events -> (maybe) frame. Minimized windows
        skip rendering entirely (main.rs:543-552)."""
        keys = self.feed(events)
        if not self.state.running or self.state.minimized:
            return None
        return self.driver.step(keys, dt=dt)

    # -- terminal output -----------------------------------------------------
    def render_ansi(self) -> str:
        """Last frame as 24-bit ANSI half-blocks (2 pixels per cell)."""
        img = self.driver.readback()
        h, w = img.shape[:2]
        cols = min(self.cols, w)
        rows = max(2, int(cols * (h / w) * 0.5) * 2)
        ys = (np.arange(rows) * (h - 1) / max(rows - 1, 1)).astype(int)
        xs = (np.arange(cols) * (w - 1) / max(cols - 1, 1)).astype(int)
        px = img[np.ix_(ys, xs)]
        out = []
        for r in range(0, rows - 1, 2):
            line = []
            for c in range(cols):
                tr, tg, tb = px[r, c][:3]
                br, bg, bb = px[r + 1, c][:3]
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg};{bb}m▀")
            out.append("".join(line) + "\x1b[0m")
        return "\n".join(out)

    def run(self, max_frames: Optional[int] = None,
            preview_every: int = 8) -> None:
        """Raw-mode stdin loop (requires a tty)."""
        import select
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

        def read_event(events: list) -> None:
            """Parse one key/escape sequence by prefix: CSI (ESC [ ...)
            and SS3 (ESC O ...) read until their final byte; a lone ESC —
            or ESC followed by an unrelated key — stays a bare ESC event
            (exit) instead of swallowing the next keys (ADVICE r2)."""
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                events.append(ch)
                return
            if not select.select([fd], [], [], 0.01)[0]:
                events.append("\x1b")               # lone ESC
                return
            nxt = sys.stdin.read(1)
            if nxt not in "[O":                     # ESC then a normal key
                events.append("\x1b")
                events.append(nxt)
                return
            seq = ch + nxt
            while select.select([fd], [], [], 0.01)[0]:
                c = sys.stdin.read(1)
                seq += c
                if "\x40" <= c <= "\x7e":           # CSI final byte
                    break
            events.append(seq)

        try:
            # xterm mouse reporting: button events, SGR-1006 encoding
            sys.stdout.write("\x1b[?1000h\x1b[?1006h")
            sys.stdout.flush()
            frame = 0
            last = time.perf_counter()
            while self.state.running:
                events = []
                while select.select([fd], [], [], 0.0)[0]:
                    read_event(events)
                now = time.perf_counter()
                self.step(events, dt=now - last)
                last = now
                frame += 1
                if frame % preview_every == 0 and not self.state.minimized:
                    sys.stdout.write("\x1b[H" + self.render_ansi() + "\n"
                                     + self.driver.title() + "\n")
                    sys.stdout.flush()
                if max_frames is not None and frame >= max_frames:
                    break
        finally:
            sys.stdout.write("\x1b[?1006l\x1b[?1000l")
            sys.stdout.flush()
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
