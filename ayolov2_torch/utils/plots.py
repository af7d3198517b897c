"""Plots: labelled boxes, batch mosaics, label histograms, PR and metric
curves and the confusion matrix, drawn in numpy and written as PNG.

The counterpart of ``ayolov2_tpu/utils/plots.py``, with the same functions
and signatures. The JAX package draws boxes and text with OpenCV and charts
with matplotlib; neither is on the card's machine, so this module has its
own rasteriser:

- boxes are drawn without anti-aliasing, with OpenCV's line thickness ``tl``
  and label box;
- text is a 5x7 ASCII bitmap font held below, scaled by whole numbers (not
  OpenCV's Hershey font or matplotlib's DejaVu);
- each chart is a figure of matplotlib's pixel size for the JAX code's
  ``figsize`` and ``dpi`` (1440x600 for the histogram, 1800x1200 for the
  curves, 2000x1600 for the confusion matrix) with an axes frame, ticks and
  tick labels, axis labels, polylines of the same widths (points at the
  figure's dpi), legend entries, histogram bars, the wh scatter at alpha
  0.3 and the heat map in matplotlib's Blues ramp with NaN cells left
  white; the layout follows ``tight_layout`` in spirit, not to the pixel.

Images are BGR uint8, as the JAX package's OpenCV calls take them; files
are written by ``utils/png.py``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ayolov2_torch.utils.boxes import xywh2xyxy
from ayolov2_torch.utils.constants import PLOT_COLORS
from ayolov2_torch.utils.png import write_png

Color = Tuple[int, int, int]

# ---- text: a 5x7 bitmap font ----------------------------------------------------------

# printable ASCII from ' ' (32) to '~' (126): five column bytes a glyph, bit 0 the top row
_FONT_HEX = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 3649552250 0005030000"
    " 001c224100 0041221c00 082a1c2a08 08083e0808 0050300000 0808080808 0060600000 2010080402"
    " 3e5149453e 00427f4000 4261514946 2141454b31 1814127f10 2745454539 3c4a494930 0171090503"
    " 3649494936 064949291e 0036360000 0056360000 0008142241 1414141414 4122140800 0201510906"
    " 324979413e 7e1111117e 7f49494936 3e41414122 7f4141221c 7f49494941 7f09090101 3e41415132"
    " 7f0808087f 00417f4100 2040413f01 7f08142241 7f40404040 7f0204027f 7f0408107f 3e4141413e"
    " 7f09090906 3e4151215e 7f09192946 4649494931 01017f0101 3f4040403f 1f2040201f 7f2018207f"
    " 6314081463 0304780403 6151494543 00007f4141 0204081020 41417f0000 0402010204 4040404040"
    " 0001020400 2054545478 7f48444438 3844444420 384444487f 3854545418 087e090102 081454543c"
    " 7f08040478 00447d4000 2040443d00 007f102844 00417f4000 7c04180478 7c08040478 3844444438"
    " 7c14141408 081414187c 7c08040408 4854545420 043f444020 3c4040207c 1c2040201c 3c4030403c"
    " 4428102844 0c5050503c 4464544c44 0008364100 00007f0000 0041360800 08082a1c08"
)
_GLYPHS = np.array(
    [[[(int(g[2 * c: 2 * c + 2], 16) >> r) & 1 for c in range(5)] for r in range(7)]
     for g in _FONT_HEX.split()], bool)  # (95, 7, 5)


def text_size(text: str, k: int) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` at glyph scale ``k``."""
    return max(len(text) * 6 - 1, 0) * k, 7 * k


def _text_mask(text: str, k: int) -> np.ndarray:
    """The (7k, width) bool mask of ``text``; characters outside ASCII
    print as '?'."""
    codes = [ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32 for ch in text]
    if not codes:
        return np.zeros((7 * k, 0), bool)
    cells = np.zeros((len(codes), 7, 6), bool)
    cells[:, :, :5] = _GLYPHS[codes]
    mask = cells.transpose(1, 0, 2).reshape(7, -1)[:, :-1]
    return np.repeat(np.repeat(mask, k, 0), k, 1)


def _paint(img: np.ndarray, y0: int, x0: int, mask: np.ndarray, color: Color) -> None:
    """Set the pixels of ``mask`` placed with its corner at (y0, x0)."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    ya, xa = max(y0, 0), max(x0, 0)
    yb, xb = min(y0 + mh, h), min(x0 + mw, w)
    if ya >= yb or xa >= xb:
        return
    sub = mask[ya - y0: yb - y0, xa - x0: xb - x0]
    img[ya:yb, xa:xb][sub] = color


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], k: int, color: Color,
             vertical: bool = False) -> None:
    """Draw ``text`` with its bottom-left corner at ``org`` (x, y), as
    ``cv2.putText`` places it; ``vertical`` turns it a quarter counter-
    clockwise (reading upwards, bottom-left corner at ``org``)."""
    mask = _text_mask(text, k)
    if vertical:
        mask = np.rot90(mask)
    _paint(img, org[1] - mask.shape[0] + 1, org[0], mask, color)


def _fill_rect(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color: Color) -> None:
    """Fill the rectangle between two corners (x, y), both inclusive."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        img[ya: yb + 1, xa: xb + 1] = color


def _rectangle(img: np.ndarray, c1: Tuple[int, int], c2: Tuple[int, int], color: Color,
               thickness: int) -> None:
    """A box outline whose edges are lines ``thickness`` wide centred on
    the corners' rows and columns (``cv2.rectangle`` without AA)."""
    lo, hi = thickness // 2, (thickness - 1) // 2
    (xa, xb), (ya, yb) = sorted((c1[0], c2[0])), sorted((c1[1], c2[1]))
    _fill_rect(img, (xa - lo, ya - lo), (xb + hi, ya + hi), color)
    _fill_rect(img, (xa - lo, yb - lo), (xb + hi, yb + hi), color)
    _fill_rect(img, (xa - lo, ya - lo), (xa + hi, yb + hi), color)
    _fill_rect(img, (xb - lo, ya - lo), (xb + hi, yb + hi), color)


def _font_scale(font_scale: float) -> int:
    """The glyph scale whose height is nearest OpenCV's Hershey simplex
    text at ``font_scale`` (27 pixels a unit of scale)."""
    return max(1, round(27 * font_scale / 7))


# ---- boxes and mosaics -----------------------------------------------------------------


def color_for(idx: int) -> tuple:
    c = PLOT_COLORS[int(idx) % len(PLOT_COLORS)]
    return tuple(int(v) for v in c)


def plot_one_box(
    img: np.ndarray,
    box: Sequence[float],
    label: Optional[str] = None,
    color: Optional[tuple] = None,
    line_thickness: Optional[int] = None,
) -> None:
    """Draw one xyxy box (and its label on a filled box above its top-left
    corner) into ``img`` in place."""
    tl = line_thickness or max(round(0.002 * (img.shape[0] + img.shape[1]) / 2), 1)
    color = color or (128, 128, 128)
    c1, c2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    _rectangle(img, c1, c2, color, tl)
    if label:
        k = _font_scale(tl / 3)
        tw, th = text_size(label, k)
        _fill_rect(img, c1, (c1[0] + tw, c1[1] - th - 3), color)
        put_text(img, label, (c1[0], c1[1] - 2), k, (225, 255, 255))


def draw_labels(
    img: np.ndarray,
    labels: np.ndarray,
    names: Optional[Sequence[str]] = None,
    norm_xywh: bool = True,
) -> np.ndarray:
    """A copy of ``img`` with (n, 5) [cls, box] labels drawn on it."""
    out = img.copy()
    h, w = out.shape[:2]
    for lab in np.asarray(labels).reshape(-1, 5):
        cls = int(lab[0])
        box = xywh2xyxy(lab[1:] * np.array([w, h, w, h], np.float32)) if norm_xywh else lab[1:]
        name = names[cls] if names and cls < len(names) else str(cls)
        plot_one_box(out, box, label=name, color=color_for(cls))
    return out


def _png_path(save_path: Union[str, Path]) -> Path:
    path = Path(save_path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"{path}: the port writes its plots as PNG only")
    return path


def plot_images(
    images: np.ndarray,
    targets: np.ndarray,
    target_mask: Optional[np.ndarray],
    save_path: Union[str, Path],
    names: Optional[Sequence[str]] = None,
    max_images: int = 16,
) -> None:
    """A batch mosaic with the labels drawn: ``ns`` x ``ns`` tiles of the
    images on white. images: (B, H, W, 3) uint8; targets: (M, 6) [img, cls,
    xywh normalised], ``target_mask`` selecting the real rows."""
    bs = min(len(images), max_images)
    ns = int(np.ceil(bs ** 0.5))
    h, w = images.shape[1:3]
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    targets = np.asarray(targets)
    if target_mask is not None:
        targets = targets[np.asarray(target_mask)]
    for i in range(bs):
        r, c = divmod(i, ns)
        tile = np.asarray(images[i]).copy()
        rows = targets[targets[:, 0] == i]
        if len(rows):
            tile = draw_labels(tile, rows[:, 1:], names)
        mosaic[r * h: (r + 1) * h, c * w: (c + 1) * w] = tile
    write_png(_png_path(save_path), mosaic)


# ---- charts ----------------------------------------------------------------------------


def _hex(code: str) -> Color:
    """A matplotlib '#rrggbb' colour as BGR."""
    return int(code[5:7], 16), int(code[3:5], 16), int(code[1:3], 16)


_CYCLE = [_hex(c) for c in ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
                            "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")]
_GREY, _BLUE, _BLACK = (128, 128, 128), (255, 0, 0), (0, 0, 0)
_EDGE = (204, 204, 204)  # the legend frame's 0.8 grey
_LEGEND_PT = 7  # the legends' font size in JAX's figures
# matplotlib's Blues, the nine ColorBrewer anchors it interpolates (RGB)
_BLUES = np.array([[247, 251, 255], [222, 235, 247], [198, 219, 239], [158, 202, 225],
                   [107, 174, 214], [66, 146, 198], [33, 113, 181], [8, 81, 156], [8, 48, 107]],
                  np.float64)


def blues(v: np.ndarray) -> np.ndarray:
    """Values in [0, 1] as BGR uint8 on the Blues ramp; NaN is white."""
    v = np.asarray(v, np.float64)
    t = np.clip(np.nan_to_num(v, nan=0.0), 0, 1) * (len(_BLUES) - 1)
    i = np.minimum(t.astype(int), len(_BLUES) - 2)
    f = (t - i)[..., None]
    rgb = _BLUES[i] * (1 - f) + _BLUES[i + 1] * f
    out = np.round(rgb[..., ::-1]).astype(np.uint8)
    out[np.isnan(v)] = 255
    return out


def nice_ticks(lo: float, hi: float, most: int = 6) -> np.ndarray:
    """Ticks at multiples of 1, 2, 2.5 or 5 times a power of ten inside
    [lo, hi], at most ``most`` + 1 of them (matplotlib's default locator)."""
    span = hi - lo
    if not np.isfinite(span) or span <= 0:
        return np.array([lo])
    mag = 10.0 ** math.floor(math.log10(span / most))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if span / (m * mag) <= most)
    first = math.ceil(lo / step - 1e-9) * step
    return np.arange(first, hi + step * 1e-6, step)


def tick_labels(ticks: np.ndarray) -> List[str]:
    """The fewest decimals that keep every tick apart and exact."""
    for d in range(6):
        labels = [f"{t:.{d}f}" for t in ticks]
        if all(abs(float(s) - t) < 1e-9 * max(1.0, abs(t)) for s, t in zip(labels, ticks)):
            break
    return [s if s != "-" + "0" * len(s[1:]) else s[1:] for s in labels]


class _Figure:
    """A white canvas of ``figsize`` x ``dpi`` pixels, with sizes in points."""

    def __init__(self, figsize: Tuple[float, float], dpi: int) -> None:
        self.dpi = dpi
        self.img = np.full((round(figsize[1] * dpi), round(figsize[0] * dpi), 3), 255, np.uint8)

    def px(self, points: float) -> float:
        return points * self.dpi / 72

    def k(self, fontsize: float) -> int:
        """Glyph scale of a font size in points (cap height 0.72 em)."""
        return max(1, round(self.px(fontsize) * 0.72 / 7))

    @property
    def pad(self) -> int:  # tight_layout's pad: 1.08 font sizes of 10 points
        return round(self.px(10.8))


class _Axes:
    """A data rectangle at pixel box (x0, y0, x1, y1) of ``fig`` with the
    data limits ``xlim`` and ``ylim`` (y up, or down with ``y_down``)."""

    def __init__(self, fig: _Figure, box, xlim, ylim, y_down: bool = False) -> None:
        self.fig, self.img = fig, fig.img
        self.x0, self.y0, self.x1, self.y1 = box
        self.xlim, self.ylim, self.y_down = xlim, ylim, y_down
        self.xlabel = self.ylabel = ""

    def to_px(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Continuous pixel coordinates of data points."""
        fx = (np.asarray(x, np.float64) - self.xlim[0]) / (self.xlim[1] - self.xlim[0])
        fy = (np.asarray(y, np.float64) - self.ylim[0]) / (self.ylim[1] - self.ylim[0])
        px = self.x0 + fx * (self.x1 - self.x0)
        py = self.y0 + fy * (self.y1 - self.y0) if self.y_down else self.y1 - fy * (self.y1 - self.y0)
        return px, py

    def _clip_mask(self, ys, xs) -> np.ndarray:
        return (ys >= self.y0) & (ys <= self.y1) & (xs >= self.x0) & (xs <= self.x1)

    def line(self, x, y, color: Color, width_pt: float) -> None:
        """A polyline ``width_pt`` points wide, clipped to the axes."""
        px, py = self.to_px(x, y)
        ok = np.isfinite(px) & np.isfinite(py)
        px, py = px[ok], py[ok]
        if len(px) == 0:
            return
        if len(px) > 1:  # samples every half pixel along each segment
            n = np.maximum(np.ceil(np.hypot(np.diff(px), np.diff(py)) / 0.5), 1).astype(int)
            seg = np.repeat(np.arange(len(n)), n)
            t = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
            t = t / n[seg]
            px = np.append(px[seg] + t * (px[seg + 1] - px[seg]), px[-1])
            py = np.append(py[seg] + t * (py[seg + 1] - py[seg]), py[-1])
        self._stamp(px, py, self.fig.px(width_pt) / 2, color)

    def _disc(self, r: float) -> Tuple[np.ndarray, np.ndarray]:
        n = int(math.ceil(r))
        dy, dx = np.mgrid[-n: n + 1, -n: n + 1]
        keep = dx ** 2 + dy ** 2 <= max(r, 0.5) ** 2
        return dy[keep], dx[keep]

    def _stamp(self, px, py, r: float, color: Color) -> None:
        dy, dx = self._disc(r)
        ys = (np.floor(py)[:, None].astype(int) + dy[None]).ravel()
        xs = (np.floor(px)[:, None].astype(int) + dx[None]).ravel()
        keep = self._clip_mask(ys, xs)
        self.img[ys[keep], xs[keep]] = color

    def scatter(self, x, y, size_pt2: float, color: Color, alpha: float) -> None:
        """Round markers of area ``size_pt2`` points squared, each blended at
        ``alpha`` over what is below (overlaps compound)."""
        px, py = self.to_px(x, y)
        dy, dx = self._disc(self.fig.px(math.sqrt(size_pt2)) / 2)
        ys = (np.floor(py)[:, None].astype(int) + dy[None]).ravel()
        xs = (np.floor(px)[:, None].astype(int) + dx[None]).ravel()
        keep = self._clip_mask(ys, xs)
        hits = np.zeros(self.img.shape[:2], np.int64)
        np.add.at(hits, (ys[keep], xs[keep]), 1)
        where = hits > 0
        keepf = (1 - alpha) ** hits[where][:, None]
        src = self.img[where].astype(np.float64)
        self.img[where] = np.round(src * keepf + np.array(color, np.float64) * (1 - keepf))

    def bar(self, left: float, right: float, height: float, color: Color) -> None:
        (xa, xb), (ya, yb) = self.to_px([left, right], [0, height])
        _fill_rect(self.img, (math.ceil(xa), math.ceil(min(ya, yb))),
                   (math.ceil(xb) - 1, math.ceil(max(ya, yb)) - 1), color)

    def image(self, rgb: np.ndarray) -> None:
        """An (rows, cols, 3) array filling the axes, cell (0, 0) top-left."""
        rows, cols = rgb.shape[:2]
        yi = np.clip(((np.arange(self.y0, self.y1 + 1) - self.y0 + 0.5) / (self.y1 - self.y0 + 1)
                      * rows).astype(int), 0, rows - 1)
        xi = np.clip(((np.arange(self.x0, self.x1 + 1) - self.x0 + 0.5) / (self.x1 - self.x0 + 1)
                      * cols).astype(int), 0, cols - 1)
        self.img[self.y0: self.y1 + 1, self.x0: self.x1 + 1] = rgb[yi[:, None], xi[None, :]]

    def frame(self, xticks, yticks, xlabels, ylabels, k_tick: int, xlabel: str, ylabel: str,
              k_label: int, vertical_xticks: bool = False, yticks_right: bool = False) -> None:
        """The four spines, outward ticks with their labels and the axis
        labels (the y label reading upwards)."""
        fig, img = self.fig, self.img
        lw = max(1, round(fig.px(0.8)))
        tick, gap = round(fig.px(3.5)), round(fig.px(3.5))
        _rectangle(img, (self.x0 - 1, self.y0 - 1), (self.x1 + 1, self.y1 + 1), _BLACK, lw)
        xs, _ = self.to_px(xticks, np.zeros(len(xticks)))
        bottom = self.y1 + 1 + lw // 2 + tick + gap
        for x, s in zip(xs, xlabels):
            x = int(round(x))
            _fill_rect(img, (x - lw // 2, self.y1 + 1), (x + (lw - 1) // 2, self.y1 + tick), _BLACK)
            tw, th = text_size(s, k_tick)
            if vertical_xticks:
                put_text(img, s, (x - th // 2, bottom + tw - 1), k_tick, _BLACK, vertical=True)
            else:
                put_text(img, s, (x - tw // 2, bottom + th - 1), k_tick, _BLACK)
        x_room = max([text_size(s, k_tick)[0 if vertical_xticks else 1] for s in xlabels] or [0])
        if xlabel:
            tw, th = text_size(xlabel, k_label)
            put_text(img, xlabel, ((self.x0 + self.x1 - tw) // 2, bottom + x_room + gap + th),
                     k_label, _BLACK)
        _, ys = self.to_px(np.zeros(len(yticks)), yticks)
        y_room = 0
        for y, s in zip(ys, ylabels):
            y = int(round(y))
            tw, th = text_size(s, k_tick)
            y_room = max(y_room, tw)
            if yticks_right:
                _fill_rect(img, (self.x1 + 1, y - lw // 2), (self.x1 + tick, y + (lw - 1) // 2),
                           _BLACK)
                put_text(img, s, (self.x1 + 1 + tick + gap, y + th // 2), k_tick, _BLACK)
            else:
                _fill_rect(img, (self.x0 - tick, y - lw // 2), (self.x0 - 1, y + (lw - 1) // 2),
                           _BLACK)
                put_text(img, s, (self.x0 - tick - gap - tw, y + th // 2), k_tick, _BLACK)
        if ylabel:
            tw, th = text_size(ylabel, k_label)
            x = self.x0 - tick - gap - y_room - gap - th
            put_text(img, ylabel, (x, (self.y0 + self.y1 + tw) // 2), k_label, _BLACK,
                     vertical=True)

    def legend(self, entries: Sequence[Tuple[str, Color, float]]) -> None:
        """Entries (label, colour, line width in points) in a framed box whose
        top-left corner is at axes point (1.04, 1), in 7-point text."""
        fig = self.fig
        em, k = fig.px(_LEGEND_PT), fig.k(_LEGEND_PT)
        pad, handle, space = round(0.4 * em), round(2.0 * em), round(0.8 * em)
        row = max(round(1.5 * em), 7 * k)
        width = self.legend_width(fig, [s for s, _, _ in entries])
        height = 2 * pad + row * len(entries)
        x = self.x1 + round(0.04 * (self.x1 - self.x0))
        _fill_rect(self.img, (x, self.y0), (x + width, self.y0 + height), (255, 255, 255))
        _rectangle(self.img, (x, self.y0), (x + width, self.y0 + height), _EDGE, 1)
        for i, (label, color, lw) in enumerate(entries):
            cy = self.y0 + pad + row * i + row // 2
            half = round(fig.px(lw)) // 2
            _fill_rect(self.img, (x + pad, cy - half), (x + pad + handle, cy + half), color)
            put_text(self.img, label, (x + pad + handle + space, cy + 7 * k // 2), k, _BLACK)

    @staticmethod
    def legend_width(fig: _Figure, labels: Sequence[str]) -> int:
        em = fig.px(_LEGEND_PT)
        return 2 * round(0.4 * em) + round(2.0 * em) + round(0.8 * em) + max(
            text_size(s, fig.k(_LEGEND_PT))[0] for s in labels)


def _margins(fig: _Figure, ylabels: Sequence[str], k_tick: int, k_label: int,
             x_tick_height: int) -> Tuple[int, int]:
    """(left, bottom) room for the y tick labels and y label, and for the x
    tick labels and x label."""
    tick_gap = round(fig.px(3.5)) * 2
    left = fig.pad + 7 * k_label + tick_gap + max([text_size(s, k_tick)[0] for s in ylabels]
                                                   or [0])
    bottom = fig.pad + 7 * k_label + tick_gap + x_tick_height + round(fig.px(3.5))
    return left, bottom


def _xy_axes(fig: _Figure, area, xlim, ylim, xlabel: str, ylabel: str,
             legend: Optional[Sequence[str]] = None) -> _Axes:
    """An x-y axes placed in ``area`` (x0, y0, x1, y1 of the figure) with
    room for its tick labels, axis labels and a legend at its right."""
    k = fig.k(10)
    left, bottom = _margins(fig, tick_labels(nice_ticks(*ylim)), k, k, 7 * k)
    x0, y0 = area[0] + left, area[1] + fig.pad
    x1, y1 = area[2] - fig.pad, area[3] - bottom
    if legend:
        x1 = x0 + int((x1 - x0 - _Axes.legend_width(fig, legend)) / 1.04)
    ax = _Axes(fig, (x0, y0, x1, y1), xlim, ylim)
    ax.xlabel, ax.ylabel = xlabel, ylabel
    return ax


def _finish(ax: _Axes) -> None:
    """The frame, nice ticks and labels of an x-y axes, over its data."""
    xt, yt = nice_ticks(*ax.xlim), nice_ticks(*ax.ylim)
    k = ax.fig.k(10)
    ax.frame(xt, yt, tick_labels(xt), tick_labels(yt), k, ax.xlabel, ax.ylabel, k)


def _limits(v: np.ndarray) -> Tuple[float, float]:
    """matplotlib's autoscale: the data range with 5% margins."""
    if len(v) == 0:
        return 0.0, 1.0
    lo, hi = float(np.min(v)), float(np.max(v))
    span = hi - lo if hi > lo else max(abs(lo), 1.0)
    return lo - 0.05 * span, hi + 0.05 * span


def plot_label_histogram(labels: List[np.ndarray], nc: int, save_path: Union[str, Path]) -> None:
    """The instances of each class (bars) and each box's width against its
    height (scatter at alpha 0.3), side by side in a 1440x600 figure."""
    found = [lab for lab in labels if len(lab)]
    alls = np.concatenate(found, 0) if found else np.zeros((0, 5))
    fig = _Figure((12, 5), 120)
    w, h = fig.img.shape[1], fig.img.shape[0]
    counts = np.bincount(alls[:, 0].astype(np.int64), minlength=nc)[:nc] if nc else np.zeros(0)
    ax = _xy_axes(fig, (0, 0, w // 2, h), (-0.5 - 0.05 * nc, nc - 0.5 + 0.05 * nc),
                  (0.0, max(float(counts.max(initial=0)) * 1.05, 1.0)), "class", "instances")
    for c, n in enumerate(counts):
        if n:
            ax.bar(c - 0.4, c + 0.4, float(n), _CYCLE[0])
    _finish(ax)
    ax = _xy_axes(fig, (w // 2, 0, w, h), _limits(alls[:, 3]), _limits(alls[:, 4]),
                  "width", "height")
    ax.scatter(alls[:, 3], alls[:, 4], 3, _CYCLE[0], 0.3)
    _finish(ax)
    write_png(_png_path(save_path), fig.img)


def _curves(px: np.ndarray, ys: np.ndarray, names: Sequence[str], line_labels: Sequence[str],
            mean: np.ndarray, xlabel: str, ylabel: str, save_path) -> None:
    """Per-class curves (columns of ``ys``) and their mean in blue, 3 points
    wide, on [0, 1] x [0, 1] in a 1800x1200 figure; with 1-20 names each
    class has its colour and a legend entry, else all are grey."""
    fig = _Figure((9, 6), 200)
    h, w = fig.img.shape[:2]
    named = 0 < len(names) < 21
    ax = _xy_axes(fig, (0, 0, w, h), (0.0, 1.0), (0.0, 1.0), xlabel, ylabel,
                  legend=list(line_labels) if named else None)
    entries = []
    for i in range(ys.shape[1]):
        color = _CYCLE[i % len(_CYCLE)] if named else _GREY
        ax.line(px, ys[:, i], color, 1)
        if named:
            entries.append((line_labels[i], color, 1))
    ax.line(px, mean, _BLUE, 3)
    _finish(ax)
    if named:
        ax.legend(entries)
    write_png(_png_path(save_path), fig.img)


def plot_pr_curve(
    px: np.ndarray, py: np.ndarray, ap: np.ndarray, save_path: Union[str, Path],
    names: Sequence[str] = (),
) -> None:
    """Precision against recall for each class and their mean (the legend
    gives each class's AP at IoU 0.5)."""
    py = np.stack(py, axis=1) if isinstance(py, list) else np.asarray(py)
    labels = [f"{names[i]} {ap[i, 0]:.3f}" for i in range(py.shape[1])] \
        if 0 < len(names) < 21 else []
    _curves(px, py, names, labels, py.mean(1), "Recall", "Precision", save_path)


def plot_mc_curve(
    px: np.ndarray, py: np.ndarray, save_path: Union[str, Path],
    names: Sequence[str] = (), xlabel: str = "Confidence", ylabel: str = "Metric",
) -> None:
    """A metric (F1, P or R) against the confidence threshold for each class
    and their mean."""
    ys = np.asarray(py, np.float64).T
    labels = [names[i] for i in range(ys.shape[1])] if 0 < len(names) < 21 else []
    _curves(px, ys, names, labels, np.asarray(py).mean(0), xlabel, ylabel, save_path)


def plot_confusion_matrix(
    matrix: np.ndarray, save_path: Union[str, Path], names: Sequence[str] = ()
) -> None:
    """The confusion matrix normalised by column (true class), cells under
    0.005 left white, as a Blues heat map with its colour bar in a 2000x1600
    figure; with nc + 1 tick names (the classes and 'background') the rows
    and columns are named, the column names reading upwards."""
    nc = matrix.shape[0] - 1
    arr = matrix / (matrix.sum(0).reshape(1, -1) + 1e-6)
    arr[arr < 0.005] = np.nan
    fig = _Figure((10, 8), 200)
    h, w = fig.img.shape[:2]
    ticks = list(names) + ["background"] if 0 < len(names) < 100 else None
    named = bool(ticks) and len(ticks) == nc + 1
    k, k_small = fig.k(10), fig.k(6)
    if named:
        pos, xl, kt = np.arange(nc + 1), ticks, k_small
    else:
        pos = nice_ticks(-0.5, nc + 0.5)
        pos = pos[(pos >= 0) & (pos <= nc)]
        xl, kt = tick_labels(pos), k
    x_height = max(text_size(s, kt)[0] for s in xl) if named else 7 * kt
    left, bottom = _margins(fig, xl, kt, k, x_height)
    bar_room = round(0.05 * w) + round(0.15 * w * 0.2) + round(fig.px(7)) + text_size("0.0", k)[0]
    side = min(w - left - fig.pad - bar_room, h - fig.pad - bottom)
    x0, y0 = left, fig.pad + (h - fig.pad - bottom - side) // 2
    ax = _Axes(fig, (x0, y0, x0 + side, y0 + side), (-0.5, nc + 0.5), (-0.5, nc + 0.5),
               y_down=True)
    ax.image(blues(arr))
    ax.frame(pos, pos, xl, xl, kt, "True", "Predicted", k, vertical_xticks=named)
    bw = max(round(side / 20), 4)  # matplotlib's colour bar: aspect 20, pad 0.05
    bx = x0 + side + round(0.05 * w)
    bar = _Axes(fig, (bx, y0, bx + bw, y0 + side), (0.0, 1.0), (0.0, 1.0))
    bar.image(blues(np.linspace(1, 0, 256))[:, None])
    bt = nice_ticks(0.0, 1.0)
    bar.frame([], bt, [], tick_labels(bt), k, "", "", k, yticks_right=True)
    write_png(_png_path(save_path), fig.img)
