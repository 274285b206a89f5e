"""A small PDF plotting backend for machines without matplotlib.

It implements the part of matplotlib's API that `figures.plotting` and
`figures.master` use — `subplots`, `figure`, `close`, the `Axes` calls
(`plot`, `axhline`, `axvline`, `axvspan`, `annotate`, `pcolormesh`,
`legend`, titles, labels, limits, grid), `Figure.colorbar`, `tight_layout`,
`text`, `savefig` — and `PdfPages` for the combined document. Figures keep
their data as given (the same arrays matplotlib would plot, readable
through `get_lines`, `get_xydata`, `collections`, `texts`) and are written
as vector PDF: lines, rectangles and Helvetica text, with a mesh embedded
as one Flate-compressed RGB image at the page's resolution (the reference
rasterizes it too). Layout is simpler than matplotlib's: fixed margins,
5% data margins, "nice" ticks, mathtext shown as plain text.

`figures.backend` picks it when matplotlib is not importable.
"""

from __future__ import annotations

import math
import zlib
from pathlib import Path
from typing import List

import numpy as np

_COLORS = {
    "tab:blue": "#1f77b4", "tab:red": "#d62728", "tab:green": "#2ca02c",
    "tab:purple": "#9467bd", "tab:orange": "#ff7f0e", "royalblue": "#4169e1",
    "darkgreen": "#006400", "mediumvioletred": "#c71585", "darkorange": "#ff8c00",
    "darkred": "#8b0000", "darkgoldenrod": "#b8860b", "grey": "#808080",
    "gray": "#808080", "darkgray": "#a9a9a9", "tomato": "#ff6347", "black": "#000000",
    "white": "#ffffff",
}
_CYCLE = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple"]
# viridis at 16 evenly spaced points, interpolated linearly between them
_VIRIDIS = np.array([
    [0.267, 0.0049, 0.3294], [0.2827, 0.1002, 0.4222], [0.2771, 0.1852, 0.4899],
    [0.2539, 0.2653, 0.53], [0.222, 0.3392, 0.5488], [0.1906, 0.4071, 0.5561],
    [0.1636, 0.4711, 0.5581], [0.1391, 0.5338, 0.5553], [0.1206, 0.5964, 0.5436],
    [0.1347, 0.6586, 0.5176], [0.208, 0.7187, 0.4729], [0.3278, 0.774, 0.4066],
    [0.4775, 0.8214, 0.3182], [0.6473, 0.8584, 0.2099], [0.8249, 0.8847, 0.1062],
    [0.9932, 0.9062, 0.1439]])
_DASHES = {"-": None, "--": (5.0, 2.5), "-.": (5.0, 2.0, 1.2, 2.0), ":": (1.2, 2.0)}
_GREEK = {
    r"\xi": "xi", r"\kappa": "kappa", r"\tau": "tau", r"\beta": "beta", r"\pi": "pi",
    r"\bar": "", r"\times": "x", r"\lambda": "lambda", r"\eta": "eta",
}
DPI = 72.0  # PDF points per inch
MESH_DPI = 150.0


def _rgb(color) -> tuple:
    if color is None:
        color = "black"
    if isinstance(color, (tuple, list)):
        return tuple(float(c) for c in color[:3])
    hexs = _COLORS.get(color, color if str(color).startswith("#") else "#000000")
    return tuple(int(hexs[i:i + 2], 16) / 255.0 for i in (1, 3, 5))


def _plain(s) -> str:
    """Mathtext as plain Latin-1 text: ``$\\xi = 10.2$`` → ``xi = 10.2``."""
    s = str(s).replace("$", "")
    for k, v in _GREEK.items():
        s = s.replace(k, v)
    for ch in "{}\\^":
        s = s.replace(ch, "")
    s = s.replace("_", "")
    table = {"ξ": "xi", "κ": "kappa", "τ": "tau", "β": "beta", "→": "->", "×": "x",
             "≈": "~", "−": "-", "π": "pi"}
    return "".join(table.get(c, c) if ord(c) > 255 else c for c in s)


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _text_width(s: str, size: float) -> float:
    return 0.52 * size * len(s)


def _nice_ticks(lo: float, hi: float, n: int = 6) -> List[float]:
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo] if math.isfinite(lo) else []
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1.0, 2.0, 2.5, 5.0, 10.0) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    ticks = []
    t = first
    while t <= hi + 1e-9 * step:
        ticks.append(0.0 if abs(t) < 1e-12 * step else t)
        t += step
    return ticks


def _fmt_tick(v: float) -> str:
    return f"{v:.6g}"


def viridis(values: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] of values in [0, 1] (NaN → white)."""
    v = np.clip(np.nan_to_num(values, nan=0.0), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(np.floor(v).astype(int), len(_VIRIDIS) - 2)
    f = (v - i)[..., None]
    rgb = _VIRIDIS[i] * (1.0 - f) + _VIRIDIS[i + 1] * f
    rgb[np.isnan(values)] = 1.0
    return rgb


class Line2D:
    def __init__(self, x, y, color, lw, ls, label):
        self._xy = np.column_stack([np.asarray(x, np.float64).ravel(),
                                    np.asarray(y, np.float64).ravel()])
        self.color, self.lw, self.ls = color, lw, ls
        self._label = label

    def get_xydata(self) -> np.ndarray:
        return self._xy

    def get_label(self) -> str:
        return self._label


class _RefLine(Line2D):
    """axhline/axvline: one coordinate in data space, the other spanning
    the axes ([0, 1] in axes coordinates), as matplotlib stores them."""

    def __init__(self, horizontal: bool, value: float, color, lw, ls, label):
        v = float(value)
        x, y = ([0.0, 1.0], [v, v]) if horizontal else ([v, v], [0.0, 1.0])
        super().__init__(x, y, color, lw, ls, label)
        self.horizontal = horizontal


class Text:
    def __init__(self, text, xy, color, fontsize, ha="left", va="baseline", rotation=0.0,
                 xytext=None, arrowprops=None):
        self._text = str(text)
        self.xy, self.xytext = tuple(float(v) for v in xy), xytext
        self.color, self.fontsize, self.ha, self.va = color, fontsize, ha, va
        self.rotation, self.arrowprops = rotation, arrowprops

    def get_text(self) -> str:
        return self._text


class QuadMesh:
    def __init__(self, x, y, c, alpha):
        self.x, self.y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        self.c = np.asarray(c, np.float64)
        self.alpha = alpha
        self.edges_x, self.edges_y = _edges(self.x), _edges(self.y)

    def get_array(self) -> np.ndarray:
        return self.c

    def get_coordinates(self) -> np.ndarray:
        gx, gy = np.meshgrid(self.edges_x, self.edges_y)
        return np.stack([gx, gy], axis=-1)

    def norm(self):
        finite = self.c[np.isfinite(self.c)]
        return (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)


def _edges(v: np.ndarray) -> np.ndarray:
    """Cell edges of 'nearest' shading: midpoints, extended at both ends."""
    if v.size == 1:
        return np.array([v[0] - 0.5, v[0] + 0.5])
    mid = 0.5 * (v[1:] + v[:-1])
    return np.concatenate([[2 * v[0] - mid[0]], mid, [2 * v[-1] - mid[-1]]])


class Axes:
    def __init__(self, fig, rect):
        self.figure, self.rect = fig, rect  # rect: (x0, y0, w, h) in figure fractions
        self._lines: List[Line2D] = []
        self.texts: List[Text] = []
        self.collections: List[QuadMesh] = []
        self._spans: list = []
        self._title = self._xlabel = self._ylabel = ""
        self._grid = (True, 1.0)
        self._xlim = self._ylim = None
        self._legend = None
        self._colorbar = None
        self._cycle = 0
        self._children = 0  # artists added, for matplotlib's "_child<n>" labels

    def _child_label(self, label) -> str:
        self._children += 1
        return label if label is not None else f"_child{self._children - 1}"

    # -- artists --------------------------------------------------------------
    def plot(self, x, y, color=None, lw=1.5, ls="-", label=None, linewidth=None,
             linestyle=None, **_):
        if color is None:
            color = _CYCLE[self._cycle % len(_CYCLE)]
            self._cycle += 1
        line = Line2D(x, y, color, linewidth or lw, linestyle or ls, self._child_label(label))
        self._lines.append(line)
        return [line]

    def axhline(self, y, color=None, lw=1.0, ls="-", label=None, **_):
        line = _RefLine(True, y, color, lw, ls, self._child_label(label))
        self._lines.append(line)
        return line

    def axvline(self, x, color=None, lw=1.0, ls="-", label=None, **_):
        line = _RefLine(False, x, color, lw, ls, self._child_label(label))
        self._lines.append(line)
        return line

    def axvspan(self, x0, x1, color="gray", alpha=0.2, **_):
        self._child_label(None)
        self._spans.append((float(x0), float(x1), color, alpha))

    def annotate(self, text, xy, xytext=None, color=None, fontsize=10, ha="left",
                 va="baseline", rotation=0.0, arrowprops=None, **_):
        self._child_label(None)
        t = Text(text, xy, color or (arrowprops or {}).get("color"), fontsize, ha, va,
                 rotation, xytext, arrowprops)
        self.texts.append(t)
        return t

    def pcolormesh(self, x, y, c, cmap="viridis", alpha=1.0, shading="auto",
                   rasterized=True, **_):
        self._child_label(None)
        mesh = QuadMesh(x, y, c, alpha)
        self.collections.append(mesh)
        return mesh

    def legend(self, loc="best", fontsize=8, **_):
        self._legend = (loc, fontsize)

    def grid(self, on=True, alpha=1.0, **_):
        self._grid = (bool(on), alpha)

    # -- labels and limits ------------------------------------------------------
    def set_title(self, s):
        self._title = str(s)

    def get_title(self) -> str:
        return self._title

    def set_xlabel(self, s):
        self._xlabel = str(s)

    def set_ylabel(self, s):
        self._ylabel = str(s)

    def get_lines(self) -> list:
        return list(self._lines)

    def set_xlim(self, *lim):
        self._xlim = tuple(float(v) for v in (lim[0] if len(lim) == 1 else lim))

    def set_ylim(self, *lim):
        self._ylim = tuple(float(v) for v in (lim[0] if len(lim) == 1 else lim))

    def _data_lim(self, axis: int):
        vals, sticky = [], []
        for line in self._lines:
            if isinstance(line, _RefLine) and line.horizontal != (axis == 1):
                continue
            v = line.get_xydata()[:, axis]
            vals.append(v[np.isfinite(v)])
        if axis == 0:
            for x0, x1, *_ in self._spans:
                vals.append(np.array([x0, x1]))
        for mesh in self.collections:
            e = mesh.edges_x if axis == 0 else mesh.edges_y
            sticky.append(e[[0, -1]])
        vals = [v for v in vals if v.size]
        if not vals and not sticky:
            return (0.0, 1.0)
        if sticky and not vals:
            s = np.concatenate(sticky)
            return float(s.min()), float(s.max())
        v = np.concatenate(vals + sticky)
        lo, hi = float(v.min()), float(v.max())
        if hi == lo:
            lo, hi = lo - 0.5, hi + 0.5
        pad = 0.05 * (hi - lo)
        return lo - pad, hi + pad

    def get_xlim(self):
        return self._xlim if self._xlim is not None else self._data_lim(0)

    def get_ylim(self):
        return self._ylim if self._ylim is not None else self._data_lim(1)


class Figure:
    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = tuple(float(v) for v in figsize)
        self.axes: List[Axes] = []
        self._texts: list = []

    def add_axes(self, rect) -> Axes:
        ax = Axes(self, rect)
        self.axes.append(ax)
        return ax

    def text(self, x, y, s, ha="left", va="baseline", fontsize=12, **_):
        self._texts.append((float(x), float(y), str(s), ha, va, fontsize))

    def colorbar(self, mesh, ax=None):
        ax = ax or self.axes[0]
        x0, y0, w, h = ax.rect
        ax.rect = (x0, y0, w * 0.86, h)
        ax._colorbar = (mesh, (x0 + w * 0.9, y0, w * 0.04, h))

    def tight_layout(self):
        pass

    def savefig(self, target, bbox_inches=None, **_):
        if isinstance(target, PdfPages):
            target.savefig(self)
            return
        doc = PdfPages(target)
        doc.savefig(self)
        doc.close()


def figure(figsize=(6.4, 4.8)) -> Figure:
    return Figure(figsize)


def subplots(nrows: int = 1, ncols: int = 1, figsize=(6.4, 4.8)):
    fig = Figure(figsize)
    left, right, bottom, top, gap = 0.12, 0.03, 0.12, 0.09, 0.08
    w = (1.0 - left - right - gap * (ncols - 1)) / ncols
    h = (1.0 - bottom - top - gap * (nrows - 1)) / nrows
    axes = [[fig.add_axes((left + c * (w + gap), bottom + (nrows - 1 - r) * (h + gap), w, h))
             for c in range(ncols)] for r in range(nrows)]
    if nrows == ncols == 1:
        return fig, axes[0][0]
    flat = [a for row in axes for a in row]
    return fig, tuple(flat)


def close(fig=None):
    pass


# ---------------------------------------------------------------------------
# PDF writing
# ---------------------------------------------------------------------------


class _Page:
    def __init__(self, width: float, height: float):
        self.w, self.h = width, height
        self.ops: List[str] = []
        self.images: list = []  # (name, width, height, rgb bytes)

    def color(self, rgb, stroke=True):
        self.ops.append("%.4f %.4f %.4f %s" % (*rgb, "RG" if stroke else "rg"))

    def text(self, x, y, s, size, rgb=(0, 0, 0), ha="left", va="baseline", rotation=0.0):
        s = _plain(s)
        if not s:
            return
        wdt = _text_width(s, size)
        dx = {"left": 0.0, "center": -0.5 * wdt, "right": -wdt}.get(ha, 0.0)
        dy = {"baseline": 0.0, "bottom": 0.0, "center": -0.35 * size,
              "top": -0.75 * size}.get(va, 0.0)
        self.color(rgb, stroke=False)
        if rotation:
            a = math.radians(rotation)
            c, sn = math.cos(a), math.sin(a)
            ox, oy = x + c * dx - sn * dy, y + sn * dx + c * dy
            self.ops.append("BT /F1 %.2f Tf %.4f %.4f %.4f %.4f %.2f %.2f Tm (%s) Tj ET"
                            % (size, c, sn, -sn, c, ox, oy, _esc(s)))
        else:
            self.ops.append("BT /F1 %.2f Tf %.2f %.2f Td (%s) Tj ET"
                            % (size, x + dx, y + dy, _esc(s)))

    def polyline(self, pts, rgb, lw, ls="-"):
        if len(pts) < 2:
            return
        self.color(rgb)
        dash = _DASHES.get(ls)
        self.ops.append("%.2f w [%s] 0 d" % (lw, " ".join("%.2f" % d for d in dash or ())))
        seg = ["%.2f %.2f m" % pts[0]] + ["%.2f %.2f l" % p for p in pts[1:]]
        self.ops.append(" ".join(seg) + " S")

    def rect(self, x, y, w, h, rgb, fill=True, alpha=1.0, lw=0.8):
        if fill:
            bg = tuple(alpha * c + (1.0 - alpha) for c in rgb)  # blended over white
            self.color(bg, stroke=False)
            self.ops.append("%.2f %.2f %.2f %.2f re f" % (x, y, w, h))
        else:
            self.color(rgb)
            self.ops.append("%.2f w [] 0 d %.2f %.2f %.2f %.2f re S" % (lw, x, y, w, h))

    def image(self, x, y, w, h, rgb_u8: np.ndarray):
        name = f"Im{len(self.images)}"
        self.images.append((name, rgb_u8.shape[1], rgb_u8.shape[0], rgb_u8.tobytes()))
        self.ops.append("q %.2f 0 0 %.2f %.2f %.2f cm /%s Do Q" % (w, h, x, y, name))


def _segments(xs, ys):
    """Finite runs of a polyline (NaN breaks the line, as in matplotlib)."""
    ok = np.isfinite(xs) & np.isfinite(ys)
    runs, cur = [], []
    for i in range(len(xs)):
        if ok[i]:
            cur.append((xs[i], ys[i]))
        elif cur:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    return runs


def _draw_axes(page: _Page, ax: Axes):
    W, H = page.w, page.h
    x0, y0, w, h = ax.rect
    px, py, pw, ph = x0 * W, y0 * H, w * W, h * H
    (xl, xh), (yl, yh) = ax.get_xlim(), ax.get_ylim()
    if not (xh > xl):
        xh = xl + 1.0
    if not (yh > yl):
        yh = yl + 1.0

    def tx(v):
        return px + (np.asarray(v, np.float64) - xl) / (xh - xl) * pw

    def ty(v):
        return py + (np.asarray(v, np.float64) - yl) / (yh - yl) * ph

    page.ops.append("q %.2f %.2f %.2f %.2f re W n" % (px, py, pw, ph))  # clip
    for mesh in ax.collections:
        lo, hi = mesh.norm()
        nx = max(2, min(int(pw / DPI * MESH_DPI), 2000))
        ny = max(2, min(int(ph / DPI * MESH_DPI), 2000))
        xs = xl + (np.arange(nx) + 0.5) / nx * (xh - xl)
        ys = yh - (np.arange(ny) + 0.5) / ny * (yh - yl)  # image rows top down
        ix = np.searchsorted(mesh.edges_x, xs) - 1
        iy = np.searchsorted(mesh.edges_y, ys) - 1
        inside = ((ix >= 0) & (ix < mesh.c.shape[1]))[None, :] & \
            ((iy >= 0) & (iy < mesh.c.shape[0]))[:, None]
        vals = mesh.c[np.clip(iy, 0, mesh.c.shape[0] - 1)][:, np.clip(ix, 0, mesh.c.shape[1] - 1)]
        vals = np.where(inside, (vals - lo) / (hi - lo if hi > lo else 1.0), np.nan)
        rgb = viridis(vals) * mesh.alpha + (1.0 - mesh.alpha)
        page.image(px, py, pw, ph, (rgb * 255 + 0.5).astype(np.uint8))
    for x_a, x_b, color, alpha in ax._spans:
        a, b = float(tx(x_a)), float(tx(x_b))
        page.rect(a, py, b - a, ph, _rgb(color), fill=True, alpha=alpha)
    if ax._grid[0]:
        for t in _nice_ticks(xl, xh):
            page.polyline([(float(tx(t)), py), (float(tx(t)), py + ph)], (0.88, 0.88, 0.88), 0.5)
        for t in _nice_ticks(yl, yh):
            page.polyline([(px, float(ty(t))), (px + pw, float(ty(t)))], (0.88, 0.88, 0.88), 0.5)
    for line in ax._lines:
        xy = line.get_xydata()
        if isinstance(line, _RefLine):
            if line.horizontal:
                pts = [[(px, float(ty(xy[0, 1]))), (px + pw, float(ty(xy[0, 1])))]]
            else:
                pts = [[(float(tx(xy[0, 0])), py), (float(tx(xy[0, 0])), py + ph)]]
        else:
            pts = _segments(tx(xy[:, 0]), ty(xy[:, 1]))
        for run in pts:
            page.polyline(run, _rgb(line.color), line.lw, line.ls)
    for t in ax.texts:
        if t.arrowprops is not None and t.xytext is not None:
            a = (float(tx(t.xytext[0])), float(ty(t.xytext[1])))
            b = (float(tx(t.xy[0])), float(ty(t.xy[1])))
            rgb = _rgb(t.arrowprops.get("color", t.color))
            page.polyline([a, b], rgb, t.arrowprops.get("lw", 1.0))
            for tip, tail in ((b, a), (a, b)):
                ang = math.atan2(tip[1] - tail[1], tip[0] - tail[0])
                for s in (+1, -1):
                    page.polyline([tip, (tip[0] - 6 * math.cos(ang + s * 0.4),
                                         tip[1] - 6 * math.sin(ang + s * 0.4))], rgb, 1.0)
        if t.get_text():
            page.text(float(tx(t.xy[0])), float(ty(t.xy[1])), t.get_text(), t.fontsize,
                      _rgb(t.color), t.ha, t.va, t.rotation)
    page.ops.append("Q")
    page.rect(px, py, pw, ph, (0, 0, 0), fill=False)
    for t in _nice_ticks(xl, xh):
        x = float(tx(t))
        page.polyline([(x, py), (x, py - 3)], (0, 0, 0), 0.8)
        page.text(x, py - 12, _fmt_tick(t), 8, ha="center")
    for t in _nice_ticks(yl, yh):
        y = float(ty(t))
        page.polyline([(px, y), (px - 3, y)], (0, 0, 0), 0.8)
        page.text(px - 5, y, _fmt_tick(t), 8, ha="right", va="center")
    page.text(px + pw / 2, py - 26, ax._xlabel, 10, ha="center")
    page.text(px - 34, py + ph / 2, ax._ylabel, 10, ha="center", rotation=90.0)
    page.text(px + pw / 2, py + ph + 6, ax._title, 10, ha="center")
    if ax._legend is not None:
        labelled = [ln for ln in ax._lines if not ln.get_label().startswith("_")]
        if labelled:
            size = ax._legend[1] if isinstance(ax._legend[1], (int, float)) else 8
            loc = ax._legend[0]
            lw_box = max(_text_width(_plain(ln.get_label()), size) for ln in labelled) + 30
            lh_box = (size + 4) * len(labelled) + 6
            bx = px + pw - lw_box - 6 if "right" in loc else px + 6
            by = py + 6 if "lower" in loc else py + ph - lh_box - 6
            page.rect(bx, by, lw_box, lh_box, (1, 1, 1), fill=True)
            page.rect(bx, by, lw_box, lh_box, (0.8, 0.8, 0.8), fill=False, lw=0.5)
            for k, ln in enumerate(labelled):
                y = by + lh_box - (k + 1) * (size + 4)
                page.polyline([(bx + 4, y + size * 0.35), (bx + 22, y + size * 0.35)],
                              _rgb(ln.color), ln.lw, ln.ls)
                page.text(bx + 26, y, ln.get_label(), size)
    if ax._colorbar is not None:
        mesh, (cx, cy, cw, ch) = ax._colorbar
        lo, hi = mesh.norm()
        grad = viridis(np.linspace(1.0, 0.0, 256)[:, None]) * mesh.alpha + (1.0 - mesh.alpha)
        page.image(cx * page.w, cy * page.h, cw * page.w, ch * page.h,
                   (grad * 255 + 0.5).astype(np.uint8))
        page.rect(cx * page.w, cy * page.h, cw * page.w, ch * page.h, (0, 0, 0), fill=False)
        for frac, v in ((0.0, lo), (1.0, hi)):
            page.text((cx + cw) * page.w + 3, cy * page.h + frac * ch * page.h, _fmt_tick(v), 8,
                      va="center")


def _render(fig: Figure) -> _Page:
    page = _Page(fig.figsize[0] * DPI, fig.figsize[1] * DPI)
    for ax in fig.axes:
        _draw_axes(page, ax)
    for x, y, s, ha, va, size in fig._texts:
        for k, line in enumerate(s.split("\n")):
            page.text(x * page.w, y * page.h - k * size * 1.2, line, size, ha=ha, va=va)
    return page


class PdfPages:
    """A multi-page PDF document (``savefig`` a page, ``close`` writes it)."""

    def __init__(self, path):
        self.path = Path(path)
        self.pages: List[_Page] = []

    def savefig(self, fig: Figure, **_):
        self.pages.append(_render(fig))

    def close(self):
        objs: List[bytes] = []

        def add(body: bytes) -> int:
            objs.append(body)
            return len(objs)

        font = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
                   b"/Encoding /WinAnsiEncoding >>")
        pages_id = add(b"")  # the Pages object, filled in at the end
        kids = []
        for page in self.pages:
            xobjs = []
            for name, w, h, data in page.images:
                comp = zlib.compress(data, 6)
                iid = add(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
                          b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode "
                          b"/Length %d >>\nstream\n" % (w, h, len(comp)) + comp
                          + b"\nendstream")
                xobjs.append(b"/%s %d 0 R" % (name.encode(), iid))
            content = zlib.compress("\n".join(page.ops).encode("latin-1", "replace"), 6)
            cid = add(b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(content)
                      + content + b"\nendstream")
            res = b"<< /Font << /F1 %d 0 R >> /XObject << %s >> >>" % (font, b" ".join(xobjs))
            kids.append(add(b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 %.2f %.2f] "
                            b"/Resources %s /Contents %d 0 R >>"
                            % (pages_id, page.w, page.h, res, cid)))
        objs[pages_id - 1] = (b"<< /Type /Pages /Kids [%s] /Count %d >>"
                              % (b" ".join(b"%d 0 R" % k for k in kids), len(kids)))
        catalog = add(b"<< /Type /Catalog /Pages %d 0 R >>" % pages_id)
        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objs, start=1):
            offsets.append(len(out))
            out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
        xref = len(out)
        out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
        out += b"".join(b"%010d 00000 n \n" % o for o in offsets)
        out += (b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n"
                % (len(objs) + 1, catalog, xref))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_bytes(bytes(out))
