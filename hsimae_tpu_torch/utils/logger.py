"""Structured metric logging: a JSONL metric stream, the reference's
loss-history ``.npy`` and its twin-axis loss / accuracy curve PNG.

Port-owned copy of ``MetricLogger`` and ``plot_history`` from
``hsimae_tpu/utils/logger.py``. The JAX package draws the curves with
matplotlib, which the card's machine lacks, so the port splits them in
two: :func:`curve_series` (and ``MetricLogger.curve_series``) choose each
series' points, matplotlib colour letter and axis exactly as the JAX
functions hand them to matplotlib, and :func:`render_curves` rasterises
them: a 640x480 white image (matplotlib's default figure), an axes box at
matplotlib's default subplot position, each y axis scaled to its own data
with matplotlib's 5% margins, 1-pixel polylines in the RGB of each letter,
and a legend of colour swatches at centre right. It has no font: the axis
and series names go into PNG ``tEXt`` chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hsimae_tpu_torch.utils.colormap import encode_png_rgb

FIGURE = (640, 480)  # width, height: matplotlib's 6.4 x 4.8 in at 100 dpi
AXES_BOX = (80, 58, 576, 427)  # left, top, right, bottom: subplot params .125/.88/.9/.11
MARGIN = 0.05  # matplotlib's axes.xmargin / ymargin
STYLES = ("b", "g", "c", "y", "r", "m", "k")  # plot_history's colour cycle, then "k"
LETTER_RGB = {  # matplotlib's base colours as 8-bit RGB
    "b": (0, 0, 255), "g": (0, 128, 0), "r": (255, 0, 0), "c": (0, 191, 191),
    "m": (191, 0, 191), "y": (191, 191, 0), "k": (0, 0, 0),
}
AXIS_NAMES = {"x": "epoch", "left": "loss", "right": "Average Accuracy"}
SWATCH = (20, 3, 14)  # legend swatch width, height and row pitch, pixels


@dataclasses.dataclass
class Series:
    key: str
    xs: List[float]
    ys: List[float]
    color: str  # a matplotlib colour letter
    axis: str  # "left" (loss) or "right" (accuracy)


def curve_series(hist: Dict[str, List[float]]) -> List[Series]:
    """The series ``plot_history`` draws from a history dict: keys holding
    ``loss`` on the left axis, the rest on the right; ``val_*`` series at
    ``hist["val_epoch"]`` when the lengths match, else at 0, 1, ...;
    colours from :data:`STYLES` in dict order; ``val_epoch`` and empty
    series skipped."""
    styles = iter(STYLES)
    val_x = hist.get("val_epoch") or None
    out = []
    for key, ys in hist.items():
        if not ys or key == "val_epoch":
            continue
        xs = (val_x if key.startswith("val_") and val_x is not None
              and len(val_x) == len(ys) else list(range(len(ys))))
        out.append(Series(key, list(xs), list(ys), next(styles, "k"),
                          "left" if "loss" in key else "right"))
    return out


def _limits(values: Sequence[float]) -> Tuple[float, float]:
    """An axis range over the finite ``values`` with 5% margins; a single
    value is widened by 5% of itself (by 0.05 at 0)."""
    values = [v for v in values if np.isfinite(v)]
    if not values:
        return 0.0, 1.0
    lo, hi = float(min(values)), float(max(values))
    pad = (hi - lo) * MARGIN or abs(lo) * MARGIN or MARGIN
    return lo - pad, hi + pad


def _polyline(img: np.ndarray, px: np.ndarray, py: np.ndarray, rgb) -> None:
    """1-pixel segments between consecutive points (one point: its pixel);
    a non-finite point breaks the line, as in matplotlib."""
    for k in range(max(len(px) - 1, 1)):
        k1 = min(k + 1, len(px) - 1)
        if not np.isfinite([px[k], py[k], px[k1], py[k1]]).all():
            continue
        n = int(max(abs(px[k1] - px[k]), abs(py[k1] - py[k]))) + 1
        xs = np.rint(np.linspace(px[k], px[k1], n)).astype(np.int64)
        ys = np.rint(np.linspace(py[k], py[k1], n)).astype(np.int64)
        img[ys, xs] = rgb


def series_pixels(series: Sequence[Series]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each series' points as float pixel coordinates ``(px, py)`` in the
    image: x over all series, each y axis over its own series."""
    left, top, right, bottom = AXES_BOX
    x0, x1 = _limits([x for s in series for x in s.xs])
    ylim = {axis: _limits([y for s in series if s.axis == axis for y in s.ys])
            for axis in ("left", "right")}
    out = []
    for s in series:
        y0, y1 = ylim[s.axis]
        px = left + (np.asarray(s.xs, np.float64) - x0) / (x1 - x0) * (right - left)
        py = bottom - (np.asarray(s.ys, np.float64) - y0) / (y1 - y0) * (bottom - top)
        out.append((px, py))
    return out


def legend_box(n: int) -> Tuple[Tuple[int, int, int, int], List[int]]:
    """The legend of ``n`` series at centre right: its frame ``(top,
    bottom, left, right)`` in pixels and each swatch's row."""
    sw, _, pitch = SWATCH
    left, top, right, bottom = AXES_BOX
    first = (top + bottom) // 2 - (n - 1) * pitch // 2
    rows = [first + k * pitch for k in range(n)]
    return (first - pitch // 2, rows[-1] + pitch // 2, right - sw - 22, right - 8), rows


def render_curves(series: Sequence[Series]) -> np.ndarray:
    """The curves as a ``[480, 640, 3]`` uint8 image: white, the axes box in
    black, each series in its colour (later series over earlier ones), and
    the legend's swatches in series order at centre right."""
    w, h = FIGURE
    img = np.full((h, w, 3), 255, np.uint8)
    left, top, right, bottom = AXES_BOX
    for (px, py), s in zip(series_pixels(series), series):
        _polyline(img, px, py, LETTER_RGB[s.color])
    img[top, left:right + 1] = img[bottom, left:right + 1] = 0
    img[top:bottom + 1, left] = img[top:bottom + 1, right] = 0
    if series:
        (y0, y1, x0, x1), rows = legend_box(len(series))
        img[y0:y1 + 1, x0:x1 + 1] = 255
        img[[y0, y1], x0:x1 + 1] = img[y0:y1 + 1, [x0, x1]] = 204
        sw, sh, _ = SWATCH
        for y, s in zip(rows, series):
            img[y - sh // 2:y + sh // 2 + 1, x1 - 6 - sw:x1 - 6] = LETTER_RGB[s.color]
    return img


def save_curves(path: str, series: Sequence[Series]) -> None:
    """Write :func:`render_curves` as a PNG whose ``tEXt`` chunks name the
    axes and, in legend order, each series with its colour and axis."""
    text = {f"{k} axis": v for k, v in AXIS_NAMES.items()}
    text["legend"] = "\n".join(f"{s.key} {s.color} {s.axis}" for s in series)
    with open(path, "wb") as f:
        f.write(encode_png_rgb(render_curves(series), text))


def plot_history(path: str, hist: Dict[str, List[float]]) -> None:
    """Twin-axis loss / accuracy curves from a history dict
    (:func:`curve_series`), written as a PNG."""
    save_curves(path, curve_series(hist))


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train", echo: bool = True):
        self.log_dir = log_dir
        self.echo = echo
        self._fh = None
        self.history: List[Dict] = []
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.monotonic()

    def log(self, step: Optional[int] = None, **metrics) -> None:
        rec = {"t": round(time.monotonic() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("t",)
            )
            print(f"[{rec['t']:9.2f}s] {body}", flush=True)

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.history if key in r]

    def save_history_npy(self, path: str, keys=("train_loss", "val_loss")) -> None:
        """Reference-compatible loss history dump."""
        hist = [self.series(k) for k in keys]
        np.save(path, np.array(hist, dtype=object), allow_pickle=True)

    def curve_series(self) -> List[Series]:
        """The series ``save_curves_png`` draws: ``train_loss`` (b) and
        ``val_loss`` (g) on the left axis, ``train_aa`` (y) and ``val_aa``
        (r) on the right, each at 0, 1, ..., those logged at all."""
        out = []
        for key, color, axis in (("train_loss", "b", "left"), ("val_loss", "g", "left"),
                                 ("train_aa", "y", "right"), ("val_aa", "r", "right")):
            ys = self.series(key)
            if ys:
                out.append(Series(key, list(range(len(ys))), ys, color, axis))
        return out

    def save_curves_png(self, path: str) -> None:
        """Twin-axis loss / average-accuracy plot of the logged series."""
        save_curves(path, self.curve_series())

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
