"""Device-side field rendering (counterpart of ``lb2d_tpu.utils.render``).

The reference's ``Field_Visualizer_Canvas`` round-trips every frame through
the host (``field_visualizer.py:31-58, 146-161``). Here the colormap lookup
runs on the field's device: normalise with clim, index a 256-entry LUT,
emit uint8 RGB; only the small image crosses to the host.
:class:`FieldAnimator` is the run-k-steps-per-frame loop with optional PNG
capture (``field_visualizer.py:61-161``); :class:`LiveView` shows frames in
a terminal or an HTML page.

Matplotlib is imported only by :func:`colormap_lut`: where it is missing
(the GPU machine has none), pass ``render_field``, :class:`FieldAnimator`
and :class:`LiveView` a LUT of your own (``lut=``), for example
``anchor_lut(MAGMA_ANCHORS)``, which needs numpy only. PNGs are written
by a small writer of this module, without matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["colormap_lut", "anchor_lut", "MAGMA_ANCHORS", "render_field",
           "FieldAnimator", "LiveView"]

# matplotlib's magma at 0, 1/8, ..., 1, as uint8 RGB
MAGMA_ANCHORS = ((0, 0, 4), (28, 16, 68), (79, 18, 123), (129, 37, 129),
                 (181, 54, 122), (229, 80, 100), (251, 135, 97),
                 (254, 194, 135), (252, 253, 191))


def colormap_lut(name: str = "magma") -> np.ndarray:
    """256x3 uint8 LUT from matplotlib's colormaps (the reference uses
    ``cm.magma``, ``field_visualizer.py:109-116``)."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    return (np.asarray(cmap(np.linspace(0, 1, 256)))[:, :3] * 255).astype(
        np.uint8)


def anchor_lut(anchors=MAGMA_ANCHORS) -> np.ndarray:
    """256x3 uint8 LUT interpolated linearly between equally spaced anchor
    colours (``[k, 3]``, 0-255); numpy only, no matplotlib."""
    anchors = np.asarray(anchors, dtype=np.float64)
    at = np.linspace(0.0, 1.0, len(anchors))
    t = np.linspace(0.0, 1.0, 256)
    return np.stack([np.interp(t, at, anchors[:, c]) for c in range(3)],
                    axis=1).round().astype(np.uint8)


def render_field(field, clim=None, lut=None) -> torch.Tensor:
    """Colormap a 2-D field on its device -> uint8 RGB image ``[H, W, 3]``
    (a tensor on the field's device; numpy fields render on the CPU).

    ``clim=(lo, hi)`` clamps exactly like the reference's fragment shader
    (``field_visualizer.py:41-52``); defaults to the field's min/max.
    ``lut`` is a ``[256, 3]`` uint8 table (default :func:`colormap_lut`).
    """
    f = torch.as_tensor(field, dtype=torch.float32)
    if lut is None:
        lut = colormap_lut()
    lut = torch.as_tensor(lut, device=f.device)
    if clim is None:
        lo, hi = torch.min(f), torch.max(f)
    else:
        lo, hi = (torch.as_tensor(c, dtype=f.dtype, device=f.device)
                  for c in clim)
    t = torch.clamp((f - lo) / torch.clamp(hi - lo, min=1e-30), 0.0, 1.0)
    idx = torch.clamp((t * 255.0).to(torch.int32), 0, 255)
    return lut[idx.long()]


class FieldAnimator:
    """Run a model ``steps_per_frame`` at a time and yield rendered frames:
    the ``Field_Visualizer_Canvas`` loop without a host round-trip of the
    field per frame. ``lut`` (a ``[256, 3]`` uint8 table) replaces the
    matplotlib colormap ``cmap``."""

    def __init__(self, model, field: str = "rho", steps_per_frame: int = 10,
                 clim=None, cmap: str = "magma", lut=None):
        self.model = model
        self.field = field
        self.steps_per_frame = steps_per_frame
        self.clim = clim
        self._lut = colormap_lut(cmap) if lut is None else np.asarray(lut)

    def frame(self) -> np.ndarray:
        """Advance and return the next frame as a host uint8 array. Models
        with ``device_field`` render on their device and only the image
        crosses to the host; the others render ``get_fields()``."""
        self.model.run(self.steps_per_frame)
        field = None
        if hasattr(self.model, "device_field"):
            field = self.model.device_field(self.field)
        if field is None:
            field = self.model.get_fields()[self.field]
            if field.ndim == 3:  # reference layout [nx, ny, F]: field 0
                field = field[..., 0].T
        img = render_field(field, clim=self.clim, lut=self._lut)
        return img.cpu().numpy()

    def save_png(self, path: str) -> None:
        """Advance and write the next frame as a PNG (the screenshot capture
        of ``field_visualizer.py:159-161``)."""
        with open(path, "wb") as fh:
            _write_png(fh, self.frame())


class LiveView:
    """Minimal live viewer loop, the headless counterpart of the reference's
    vispy window (``field_visualizer.py:61-161``). Two sinks:

    * ``to_terminal()``: ANSI truecolor half-block rendering to a TTY,
      refreshed in place (two image rows per character row);
    * ``to_html(path)``: a self-contained HTML page with every frame as a
      base64 PNG and a JS play loop.
    """

    def __init__(self, model, field: str = "rho", steps_per_frame: int = 10,
                 clim=None, cmap: str = "magma", lut=None):
        self.anim = FieldAnimator(model, field=field,
                                  steps_per_frame=steps_per_frame,
                                  clim=clim, cmap=cmap, lut=lut)

    # -- terminal ----------------------------------------------------------
    @staticmethod
    def _ansi_frame(img: np.ndarray, max_cols: int = 100) -> str:
        h, w = img.shape[:2]
        step = max(1, int(np.ceil(w / max_cols)))
        img = img[::step, ::step]
        if img.shape[0] % 2:
            img = img[:-1]
        top, bot = img[0::2], img[1::2]
        rows = []
        for t_row, b_row in zip(top, bot):
            cells = [
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
                for (tr, tg, tb), (br, bg, bb) in zip(t_row, b_row)
            ]
            rows.append("".join(cells) + "\x1b[0m")
        return "\n".join(rows)

    def to_terminal(self, num_frames: int = 100, max_cols: int = 100,
                    out=None) -> None:
        import sys as _sys

        out = out or _sys.stdout
        for i in range(num_frames):
            frame = self.anim.frame()
            text = self._ansi_frame(frame, max_cols)
            nrows = text.count("\n") + 1
            if i:
                out.write(f"\x1b[{nrows + 1}F")  # cursor home, redraw
            out.write(text + f"\n frame {i + 1}/{num_frames}\n")
            out.flush()

    # -- HTML --------------------------------------------------------------
    def to_html(self, path: str, num_frames: int = 60, fps: int = 15,
                scale: int = 1) -> str:
        import base64
        import io

        frames64 = []
        for _ in range(num_frames):
            img = self.anim.frame()
            if scale > 1:
                img = np.repeat(np.repeat(img, scale, 0), scale, 1)
            buf = io.BytesIO()
            _write_png(buf, img)
            frames64.append(base64.b64encode(buf.getvalue()).decode())
        html = (
            "<!doctype html><meta charset='utf-8'><title>lb2d live</title>"
            "<style>body{background:#111;color:#ddd;font:14px monospace;"
            "text-align:center}</style>"
            f"<img id=v width={img.shape[1]} height={img.shape[0]}>"
            "<div id=s></div><script>const F=["
            + ",".join(f"'{f}'" for f in frames64)
            + "];let i=0;const v=document.getElementById('v'),"
            "s=document.getElementById('s');setInterval(()=>{"
            "v.src='data:image/png;base64,'+F[i];"
            "s.textContent=`frame ${i+1}/${F.length}`;"
            f"i=(i+1)%F.length}},{1000 // fps});</script>")
        with open(path, "w") as fh:
            fh.write(html)
        return path


def _write_png(buf, img: np.ndarray) -> None:
    """Tiny dependency-free PNG writer (RGB8)."""
    import struct
    import zlib

    h, w = img.shape[:2]

    def chunk(tag, data):
        buf.write(struct.pack(">I", len(data)))
        buf.write(tag)
        buf.write(data)
        buf.write(struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    buf.write(b"\x89PNG\r\n\x1a\n")
    chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    chunk(b"IDAT", zlib.compress(raw, 6))
    chunk(b"IEND", b"")
