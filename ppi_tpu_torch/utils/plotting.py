"""The plotting backend of the port's figures and schematic renders.

``pyplot()`` returns matplotlib's ``pyplot`` on the Agg backend, which the
JAX package draws with, where matplotlib is installed. The card's machine
has no matplotlib (it has PIL), so there ``pyplot()`` returns ``RASTER``:
a small stand-in for the part of pyplot's interface that ``viz``,
``render``, ``runners.figures``, ``runners.animations`` and
``runners.corl_curves`` call (``subplots``, ``close``; on an axes
``plot``, ``fill_between``, ``axhline``, ``vlines``, ``bar``,
``contour``, ``twinx``, limits, log scale, titles,
labels, legends; on a figure ``savefig`` and ``canvas.draw`` /
``canvas.buffer_rgba``), drawn with ``PIL.ImageDraw``. Its pictures carry
the same data as matplotlib's, in plainer type; a contour is drawn as
grey bands of its levels.
"""

import math
import re
from pathlib import Path

import numpy as np

DPI = 100
# matplotlib's default colour cycle (tab10) and one-letter colours
CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
LETTERS = {"b": "#0000ff", "g": "#008000", "r": "#ff0000", "c": "#00bfbf",
           "m": "#bf00bf", "y": "#bfbf00", "k": "#000000", "w": "#ffffff"}
NAMES = {"gray": "#808080", "grey": "#808080", "red": "#ff0000",
         "blue": "#0000ff", "black": "#000000", "green": "#008000",
         "white": "#ffffff", "orange": "#ffa500"}
_FMT = re.compile(r"^(?P<color>[bgrcmykw])?(?P<marker>[.os*])?"
                  r"(?P<line>--|-|:)?$")
# the box of an axes inside its cell, in pixels: left, top, right, bottom
_PAD = (44, 24, 12, 26)


def pyplot():
    """matplotlib's pyplot (Agg) where matplotlib is installed, else
    ``RASTER``."""
    try:
        import matplotlib
    except ImportError:
        return RASTER
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def rgb(color, default="C0"):
    """(r, g, b) 0-255 of a matplotlib colour spec: ``"C3"``, a letter, a
    few names, ``"#rrggbb"`` or a 0-1 RGB tuple."""
    c = default if color is None else color
    if isinstance(c, str):
        if re.fullmatch(r"C\d", c):
            c = CYCLE[int(c[1])]
        c = LETTERS.get(c, NAMES.get(c, c))
        return tuple(int(c[i:i + 2], 16) for i in (1, 3, 5))
    return tuple(int(round(255 * float(v))) for v in list(c)[:3])


class _Canvas:
    def __init__(self, fig):
        self.fig = fig
        self._buf = None

    def draw(self):
        self._buf = self.fig.render()

    def buffer_rgba(self):
        if self._buf is None:
            self.draw()
        return self._buf


class Figure:
    def __init__(self, figsize, nrows, ncols, widths=None):
        self.size = (int(round(figsize[0] * DPI)),
                     int(round(figsize[1] * DPI)))
        self.canvas = _Canvas(self)
        w = np.asarray(widths if widths else [1.0] * ncols, float)
        edges = np.concatenate([[0.0], np.cumsum(w) / w.sum()])
        self.axes = []
        for r in range(nrows):
            for c in range(ncols):
                cell = (edges[c] * self.size[0], r * self.size[1] / nrows,
                        edges[c + 1] * self.size[0],
                        (r + 1) * self.size[1] / nrows)
                box = (int(cell[0]) + _PAD[0], int(cell[1]) + _PAD[1],
                       int(cell[2]) - _PAD[2], int(cell[3]) - _PAD[3])
                self.axes.append(Axes(box))

    def tight_layout(self):
        pass

    def render(self) -> np.ndarray:
        from PIL import Image
        img = Image.new("RGBA", self.size, (255, 255, 255, 255))
        for ax in self.axes:
            ax.render(img)
        return np.asarray(img)

    def savefig(self, path, dpi=None, **_):
        from PIL import Image
        self.canvas.draw()
        Image.fromarray(self.canvas.buffer_rgba()[..., :3]).save(
            Path(path), format="PNG")


class Axes:
    """An axes box of a ``Figure``: records its artists, draws them when
    the figure renders (limits from the data unless set)."""

    def __init__(self, box, twin_of=None):
        self.box = box
        self.artists = []
        self.title = self.xlabel = self.ylabel = ""
        self.xlim = self.ylim = None
        self.ylog = False
        self.equal = False
        self.visible = True
        self.legend_on = False
        self.twins = []
        self.twin_of = twin_of
        self._color = 0

    # ---- artists ------------------------------------------------------------
    def _next_color(self):
        c = f"C{self._color % 10}"
        self._color += 1
        return c

    def plot(self, *args, **kw):
        fmt = args[-1] if args and isinstance(args[-1], str) else ""
        data = [np.asarray(a, float) for a in args
                if not isinstance(a, str)]
        y = np.atleast_1d(data[-1])
        x = (np.atleast_1d(data[0]).reshape(-1) if len(data) > 1
             else np.arange(y.shape[0], dtype=float))
        y = y.reshape(y.shape[0], -1) if y.ndim > 1 else y[:, None]
        m = _FMT.match(fmt)
        if m is None:
            raise ValueError(f"unknown format string {fmt!r}")
        marker = m.group("marker")
        line = m.group("line") or ("-" if marker is None else None)
        for k in range(y.shape[1]):
            color = kw.get("color") or m.group("color") or self._next_color()
            self.artists.append(dict(
                kind="line", x=x, y=y[:, k], color=rgb(color),
                alpha=kw.get("alpha", 1.0), line=line, marker=marker,
                lw=kw.get("lw", kw.get("linewidth", 1.5)),
                ms=kw.get("ms", kw.get("markersize", 6.0)),
                label=kw.get("label") if k == 0 else None))
        return []

    def fill_between(self, x, y1, y2=0.0, color=None, alpha=1.0, **_):
        x = np.asarray(x, float)
        y1 = np.broadcast_to(np.asarray(y1, float), x.shape)
        y2 = np.broadcast_to(np.asarray(y2, float), x.shape)
        self.artists.append(dict(kind="fill", x=x, y1=y1, y2=y2,
                                 color=rgb(color or self._next_color()),
                                 alpha=alpha))

    def axhline(self, y=0.0, color="k", lw=1.0, **_):
        self.artists.append(dict(kind="hline", y=float(y), color=rgb(color),
                                 lw=lw))

    def vlines(self, x, ymin, ymax, color="C0", alpha=1.0, **_):
        x = np.atleast_1d(np.asarray(x, float))
        self.artists.append(dict(
            kind="vlines", x=x, y0=np.broadcast_to(np.asarray(ymin, float),
                                                   x.shape),
            y1=np.broadcast_to(np.asarray(ymax, float), x.shape),
            color=rgb(color), alpha=alpha))

    def bar(self, labels, heights, yerr=None, color=None, **_):
        """Bars at 0, 1, ... (one a label), as filled boxes; error bars as
        vertical lines."""
        heights = np.asarray(heights, float)
        colors = color if isinstance(color, list) else [color] * len(heights)
        for k, h in enumerate(heights):
            x = np.array([k - 0.35, k + 0.35])
            self.fill_between(x, h, 0.0, color=colors[k] or "C0")
        if yerr is not None:
            err = np.asarray(yerr, float)
            self.vlines(np.arange(len(heights)), heights - err,
                        heights + err, color="k")

    def contour(self, x, y, z, levels=10, alpha=1.0, **_):
        self.artists.append(dict(kind="bands", x=np.asarray(x, float),
                                 y=np.asarray(y, float),
                                 z=np.asarray(z, float), levels=int(levels),
                                 alpha=alpha))

    def twinx(self):
        twin = Axes(self.box, twin_of=self)
        self.twins.append(twin)
        return twin

    # ---- settings -----------------------------------------------------------
    def set_xlim(self, lo, hi=None):
        self.xlim = (float(lo), float(hi))

    def set_ylim(self, lo, hi=None):
        self.ylim = (float(lo), float(hi))

    def set_yscale(self, scale):
        self.ylog = scale == "log"

    def set_aspect(self, aspect):
        self.equal = aspect == "equal"

    def axis(self, mode):
        self.visible = mode != "off"

    def set_title(self, text, **_):
        self.title = str(text)

    def set_xlabel(self, text, **_):
        self.xlabel = str(text)

    def set_ylabel(self, text, **_):
        self.ylabel = str(text)

    def legend(self, *args, **kw):
        self.legend_on = True

    # ---- drawing ------------------------------------------------------------
    def _limits(self):
        xs, ys = [], []
        for a in self.artists:
            data = {"line": ("y",), "fill": ("y1", "y2"),
                    "vlines": ("y0", "y1"), "bands": ("y",)}.get(a["kind"])
            if data is not None:
                xs.append(a["x"])
                ys += [a[k] for k in data]
        if self.twin_of is not None and self.xlim is None:
            self.xlim = self.twin_of._xr
        xr = self.xlim or _span(xs)
        yr = self.ylim or _span([self._ty(y) for y in ys])
        if self.ylim is not None:
            yr = (self._ty(yr[0]), self._ty(yr[1]))
        if self.equal:
            w, h = self.box[2] - self.box[0], self.box[3] - self.box[1]
            per = max((xr[1] - xr[0]) / w, (yr[1] - yr[0]) / h)
            cx, cy = 0.5 * (xr[0] + xr[1]), 0.5 * (yr[0] + yr[1])
            xr = (cx - 0.5 * per * w, cx + 0.5 * per * w)
            yr = (cy - 0.5 * per * h, cy + 0.5 * per * h)
        return xr, yr

    def _ty(self, y):
        y = np.asarray(y, float)
        if not self.ylog:
            return y
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)), np.nan)

    def render(self, img):
        from PIL import Image, ImageDraw
        x0, y0, x1, y1 = self.box
        w, h = max(x1 - x0, 2), max(y1 - y0, 2)
        xr, yr = self._limits()
        self._xr = xr
        sx = (w - 1) / ((xr[1] - xr[0]) or 1.0)
        sy = (h - 1) / ((yr[1] - yr[0]) or 1.0)
        px = lambda x: (np.asarray(x, float) - xr[0]) * sx
        py = lambda y: (h - 1) - (self._ty(y) - yr[0]) * sy
        layer = Image.new("RGBA", (w, h), (0, 0, 0, 0))
        draw = ImageDraw.Draw(layer, "RGBA")
        scale = DPI / 72.0
        for a in self.artists:
            kind = a["kind"]
            if kind == "bands":
                _bands(layer, a, px, py, w, h)
                draw = ImageDraw.Draw(layer, "RGBA")
            elif kind == "fill":
                fill = a["color"] + (int(255 * a["alpha"]),)
                pts = list(zip(px(a["x"]), py(a["y1"]))) + list(
                    zip(px(a["x"][::-1]), py(a["y2"][::-1])))
                pts = [p for p in pts if np.isfinite(p).all()]
                if len(pts) >= 3:
                    draw.polygon(pts, fill=fill)
            elif kind == "hline":
                yy = float(py(a["y"]))
                draw.line([(0, yy), (w, yy)], fill=a["color"] + (255,),
                          width=max(1, int(round(a["lw"] * scale))))
            elif kind == "vlines":
                fill = a["color"] + (int(255 * a["alpha"]),)
                for xx, ya, yb in zip(px(a["x"]), py(a["y0"]), py(a["y1"])):
                    draw.line([(xx, ya), (xx, yb)], fill=fill, width=1)
            else:
                _line(draw, a, px(a["x"]), py(a["y"]), scale)
        if self.visible:
            draw.rectangle([0, 0, w - 1, h - 1], outline=(0, 0, 0, 255))
        img.alpha_composite(layer, (x0, y0))
        text = ImageDraw.Draw(img)
        if self.visible and self.twin_of is None:
            text.text((x0, y1 + 3), f"{xr[0]:.3g}", fill=(0, 0, 0))
            text.text((x1 - 30, y1 + 3), f"{xr[1]:.3g}", fill=(0, 0, 0))
            text.text((x0 - 42, y1 - 10), _tick(yr[0], self.ylog),
                      fill=(0, 0, 0))
            text.text((x0 - 42, y0), _tick(yr[1], self.ylog), fill=(0, 0, 0))
            if self.xlabel:
                text.text((x0 + w // 2 - 3 * len(self.xlabel), y1 + 13),
                          self.xlabel, fill=(0, 0, 0))
            if self.ylabel:
                text.text((max(x0 - 42, 0), y0 + h // 2), self.ylabel[:8],
                          fill=(0, 0, 0))
        if self.title:
            text.text((x0 + w // 2 - 3 * len(self.title), y0 - 14),
                      self.title, fill=(0, 0, 0))
        if self.legend_on:
            labels = [a for a in self.artists if a.get("label")]
            for k, a in enumerate(labels):
                yy = y0 + 6 + 12 * k
                text.line([(x1 - 110, yy + 5), (x1 - 92, yy + 5)],
                          fill=a["color"], width=2)
                text.text((x1 - 88, yy), str(a["label"])[:14],
                          fill=(0, 0, 0))
        for twin in self.twins:
            twin.render(img)


def _span(arrays):
    vals = np.concatenate([np.ravel(a) for a in arrays]) if arrays \
        else np.zeros(0)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return (0.0, 1.0)
    lo, hi = float(vals.min()), float(vals.max())
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return (lo - pad, hi + pad)


def _tick(v, log):
    return f"1e{v:.2g}" if log else f"{v:.3g}"


def _line(draw, a, xs, ys, scale):
    fill = a["color"] + (int(255 * a["alpha"]),)
    ok = np.isfinite(xs) & np.isfinite(ys)
    if a["line"] is not None:
        width = max(1, int(round(a["lw"] * scale)))
        # a polyline a run of finite points; dashes as every other segment
        run = []
        for k in range(len(xs) + 1):
            if k < len(xs) and ok[k]:
                run.append((float(xs[k]), float(ys[k])))
                continue
            if len(run) >= 2:
                if a["line"] == "-":
                    draw.line(run, fill=fill, width=width, joint="curve")
                else:
                    for p, q in _dashes(run, 8.0 if a["line"] == "--"
                                        else 2.0):
                        draw.line([p, q], fill=fill, width=width)
            run = []
    if a["marker"] is not None:
        r = max(1.0, 0.5 * a["ms"] * scale * (0.4 if a["marker"] == "."
                                               else 1.0))
        for x, y in zip(xs[ok], ys[ok]):
            if a["marker"] == "s":
                draw.rectangle([x - r, y - r, x + r, y + r], fill=fill)
            elif a["marker"] == "*":
                pts = [(x + (r if k % 2 == 0 else 0.45 * r)
                        * math.sin(math.pi * k / 5),
                        y - (r if k % 2 == 0 else 0.45 * r)
                        * math.cos(math.pi * k / 5)) for k in range(10)]
                draw.polygon(pts, fill=fill)
            else:
                draw.ellipse([x - r, y - r, x + r, y + r], fill=fill)


def _dashes(points, length):
    """The segments of a dashed polyline: on ``length`` px, off as long."""
    out, on, left = [], True, length
    for (xa, ya), (xb, yb) in zip(points[:-1], points[1:]):
        seg = math.hypot(xb - xa, yb - ya)
        t = 0.0
        while seg > 0 and t < seg:
            step = min(left, seg - t)
            p = (xa + (xb - xa) * t / seg, ya + (yb - ya) * t / seg)
            q = (xa + (xb - xa) * (t + step) / seg,
                 ya + (yb - ya) * (t + step) / seg)
            if on:
                out.append((p, q))
            t += step
            left -= step
            if left <= 0:
                on, left = not on, length
    return out


def _bands(layer, a, px, py, w, h):
    """A contour's levels as alternating grey bands under the box."""
    from PIL import Image
    cols = px(a["x"])
    rows = py(a["y"])
    jj = np.clip(np.searchsorted(cols, np.arange(w)), 0, len(cols) - 1)
    order = np.argsort(rows)
    ii = order[np.clip(np.searchsorted(rows[order], np.arange(h)), 0,
                       len(rows) - 1)]
    z = a["z"][np.ix_(ii, jj)]
    lo, hi = np.nanmin(z), np.nanmax(z)
    band = np.floor(a["levels"] * (z - lo) / ((hi - lo) or 1.0)) % 2
    grey = (235 - 20 * band).astype(np.uint8)
    rgba = np.stack([grey, grey, grey,
                     np.full_like(grey, int(255 * a["alpha"]))], -1)
    layer.alpha_composite(Image.fromarray(rgba, "RGBA"))


class _Raster:
    """``RASTER``: the pyplot stand-in (``subplots`` and ``close``)."""

    def subplots(self, nrows=1, ncols=1, figsize=(6.4, 4.8), squeeze=True,
                 gridspec_kw=None, **_):
        widths = (gridspec_kw or {}).get("width_ratios")
        fig = Figure(figsize, nrows, ncols, widths)
        axs = np.empty((nrows, ncols), dtype=object)
        for k, ax in enumerate(fig.axes):
            axs[k // ncols, k % ncols] = ax
        if not squeeze:
            return fig, axs
        if nrows == ncols == 1:
            return fig, axs[0, 0]
        return fig, axs.reshape(-1)

    def close(self, fig=None):
        pass

    def show(self):
        pass


RASTER = _Raster()
