"""A small PNG plotter over numpy and the standard library — how the
port's explore service draws (the JAX package renders with matplotlib,
which the card's machine does not have).

:func:`scatter_png` draws filled discs inside a plot box, coloured on a
viridis-like ramp by a value per point (with a colour bar) or in one
colour; :func:`curves_png` draws one polyline per series, loss-like
series on the left scale and score-like ones on the right.  Each returns
the PNG's bytes and the pixel positions it drew, so a caller can check
what the image shows.  The encoder writes 8-bit RGB rows with filter
byte 0, ``zlib.compress`` and a ``zlib.crc32`` per chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

WIDTH, HEIGHT = 960, 720  # matplotlib's 8x6 inches at 120 dpi
#: The plot box: left, top, right, bottom pixel edges.
BOX = (80, 40, 860, 660)
DISC_RADIUS = 3
#: Viridis' anchors, low to high.
RAMP = np.asarray([(68, 1, 84), (59, 82, 139), (33, 145, 140),
                   (94, 201, 98), (253, 231, 37)], np.float64)
#: Series colours (matplotlib's tab10 order).
PALETTE = np.asarray([(31, 119, 180), (255, 127, 14), (44, 160, 44),
                      (214, 39, 40), (148, 103, 189), (140, 86, 75),
                      (227, 119, 194), (127, 127, 127), (188, 189, 34),
                      (23, 190, 207)], np.uint8)
_BLACK = np.asarray((0, 0, 0), np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """(height, width, 3) uint8 -> PNG bytes."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def ramp(values: np.ndarray) -> np.ndarray:
    """Each value's colour on the ramp, scaled to the values' range."""
    v = np.asarray(values, np.float64).reshape(-1)
    lo, hi = float(v.min()), float(v.max())
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    pos = t * (len(RAMP) - 1)
    i = np.minimum(pos.astype(int), len(RAMP) - 2)
    f = (pos - i)[:, None]
    return np.rint(RAMP[i] * (1 - f) + RAMP[i + 1] * f).astype(np.uint8)


def _scale(values, lo: float, hi: float, px_lo: int, px_hi: int):
    """Data values -> pixel positions, the range padded by 5 %."""
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    lo, hi = lo - pad, hi + pad
    return np.rint(px_lo + (np.asarray(values, np.float64) - lo)
                   / (hi - lo) * (px_hi - px_lo)).astype(int)


class _Canvas:
    def __init__(self):
        self.rgb = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)

    def put(self, ys, xs, color) -> None:
        ok = (ys >= 0) & (ys < HEIGHT) & (xs >= 0) & (xs < WIDTH)
        self.rgb[ys[ok], xs[ok]] = color if np.ndim(color) == 1 \
            else np.asarray(color)[ok]

    def line(self, x0, y0, x1, y1, color, width: int = 2) -> None:
        n = 2 * max(abs(x1 - x0), abs(y1 - y0)) + 1
        t = np.linspace(0.0, 1.0, n)
        xs = np.rint(x0 + (x1 - x0) * t).astype(int)
        ys = np.rint(y0 + (y1 - y0) * t).astype(int)
        for d in range(width):
            self.put(ys + d, xs, color)
            self.put(ys, xs + d, color)

    def frame(self, right_ticks: bool) -> None:
        """The plot box with five ticks on each scale."""
        left, top, right, bottom = BOX
        for a, b, c, d in ((left, top, right, top),
                           (left, bottom, right, bottom),
                           (left, top, left, bottom),
                           (right, top, right, bottom)):
            self.line(a, b, c, d, _BLACK, width=1)
        for k in range(5):
            x = left + k * (right - left) // 4
            y = top + k * (bottom - top) // 4
            self.line(x, bottom, x, bottom + 6, _BLACK, width=1)
            self.line(left - 6, y, left, y, _BLACK, width=1)
            if right_ticks:
                self.line(right, y, right + 6, y, _BLACK, width=1)

    def discs(self, xs, ys, colors) -> None:
        r = DISC_RADIUS
        dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
        keep = dy ** 2 + dx ** 2 <= r * r
        dy, dx = dy[keep], dx[keep]
        colors = np.repeat(colors, len(dy), axis=0)
        self.put((ys[:, None] + dy).reshape(-1),
                 (xs[:, None] + dx).reshape(-1), colors)


def scatter_png(points: np.ndarray, colors=None):
    """(PNG bytes, (n, 2) pixel centres (x, y), (n, 3) colours) of a
    scatter of ``points[:, :2]``, coloured by ``colors`` on the ramp."""
    pts = np.asarray(points, np.float64)
    left, top, right, bottom = BOX
    xs = _scale(pts[:, 0], pts[:, 0].min(), pts[:, 0].max(), left, right)
    ys = _scale(pts[:, 1], pts[:, 1].min(), pts[:, 1].max(), bottom, top)
    fill = ramp(colors) if colors is not None else \
        np.repeat(PALETTE[:1], len(pts), axis=0)
    canvas = _Canvas()
    canvas.frame(right_ticks=False)
    canvas.discs(xs, ys, fill)
    if colors is not None:
        # The colour bar: the ramp from low (bottom) to high (top).
        bar = ramp(np.linspace(0.0, 1.0, bottom - top + 1))[::-1]
        canvas.rgb[top:bottom + 1, right + 30:right + 50] = bar[:, None]
    return encode_png(canvas.rgb), np.stack([xs, ys], 1), fill


def curves_png(left_series: dict, right_series: dict):
    """(PNG bytes, {name: ((epochs, 2) pixel vertices, colour)}) of one
    polyline per series over epochs 1..n: ``left_series`` on the left
    scale, ``right_series`` on the right; colours in sorted-name order,
    left then right."""
    left, top, right, bottom = BOX
    canvas = _Canvas()
    canvas.frame(right_ticks=bool(right_series))
    drawn: dict = {}
    n_epochs = max(len(v) for v in (*left_series.values(),
                                    *right_series.values()))
    k = 0
    for group in (left_series, right_series):
        if not group:
            continue
        vals = np.concatenate([np.asarray(v, np.float64)
                               for v in group.values()])
        for name in sorted(group):
            v = np.asarray(group[name], np.float64)
            xs = _scale(np.arange(1, len(v) + 1), 1, n_epochs, left, right)
            ys = _scale(v, vals.min(), vals.max(), bottom, top)
            color = PALETTE[k % len(PALETTE)]
            for i in range(len(v) - 1):
                canvas.line(xs[i], ys[i], xs[i + 1], ys[i + 1], color)
            canvas.discs(xs, ys, np.repeat(color[None], len(v), axis=0))
            drawn[name] = (np.stack([xs, ys], 1), color)
            k += 1
    return encode_png(canvas.rgb), drawn
