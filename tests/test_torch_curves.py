"""Port parity for the fine-tuning curve PNGs: ``curve_series`` (and
``MetricLogger.curve_series``) of ``hsimae_tpu_torch.utils.logger`` against
what ``hsimae_tpu.utils.logger``'s ``plot_history`` and ``save_curves_png``
hand matplotlib (``Axes.plot`` recorded: xs, ys, colour, label, axis), the
port's rasterised PNG (decoded with PIL: each series' colour at its points,
within a pixel), and ``dual_branch_finetune`` writing ``finetune_curves.png``
from the JAX loop's history keys."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch
from matplotlib.axes import Axes
from PIL import Image

from hsimae_tpu.utils import logger as jlog
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.data import sampling as tsampling
from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
from hsimae_tpu_torch.train import finetune as tft
from hsimae_tpu_torch.utils import logger as tlog

AXIS_OF_LABEL = {"loss": "left", "Average Accuracy": "right"}


def recorded_plots(monkeypatch):
    """Record every ``Axes.plot`` call as ``(key, xs, ys, colour, axis)``."""
    calls = []
    real = Axes.plot

    def plot(self, *args, **kw):
        *data, style = args
        xs, ys = (list(range(len(data[0]))), data[0]) if len(data) == 1 else data
        calls.append((kw["label"], [float(v) for v in xs], [float(v) for v in ys], style,
                      AXIS_OF_LABEL[self.get_ylabel()]))
        return real(self, *args, **kw)
    monkeypatch.setattr(Axes, "plot", plot)
    return calls


def as_calls(series):
    return [(s.key, [float(v) for v in s.xs], [float(v) for v in s.ys], s.color, s.axis)
            for s in series]


def finetune_history(rng, epochs=12, eval_every=3):
    val_epoch = [e for e in range(epochs) if (e + 1) % eval_every == 0 or e == epochs - 1]
    hist = {"loss": [], "loss_rec": [], "train_aa": [], "val_loss": [], "val_oa": [],
            "val_aa": [], "val_kappa": [], "val_epoch": val_epoch}
    for k in ("loss", "loss_rec", "train_aa"):
        hist[k] = list(rng.random(epochs) * (3 if "loss" in k else 1))
    for k in ("val_loss", "val_oa", "val_aa", "val_kappa"):
        hist[k] = list(rng.random(len(val_epoch)))
    return hist


HISTORIES = {
    "finetune": lambda rng: finetune_history(rng),
    # a val series whose length differs from val_epoch's is drawn at 0, 1, ...
    "mismatched_val": lambda rng: {**finetune_history(rng), "val_oa": list(rng.random(5))},
    # past seven series the colour cycle gives "k"; empty series are skipped
    "nine_series": lambda rng: {**{f"s{i}_loss" if i % 2 else f"s{i}": list(rng.random(6))
                                   for i in range(9)}, "empty": []},
    "no_val_epoch": lambda rng: {"loss": list(rng.random(4)), "val_aa": list(rng.random(4))},
}


@pytest.mark.parametrize("kind", list(HISTORIES))
def test_curve_series_is_what_plot_history_draws(kind, monkeypatch, tmp_path):
    hist = HISTORIES[kind](np.random.default_rng(len(kind)))
    calls = recorded_plots(monkeypatch)
    jlog.plot_history(str(tmp_path / "jax.png"), hist)
    assert calls and as_calls(tlog.curve_series(hist)) == calls


def test_logger_curve_series_is_what_save_curves_png_draws(monkeypatch, tmp_path):
    rng = np.random.default_rng(4)
    loggers = [jlog.MetricLogger(echo=False), tlog.MetricLogger(echo=False)]
    for epoch in range(7):
        rec = {"train_loss": rng.random(), "train_aa": rng.random()}
        if epoch % 2:
            rec.update(val_loss=rng.random(), val_aa=rng.random())
        for lg in loggers:
            lg.log(step=epoch, **rec)
    calls = recorded_plots(monkeypatch)
    loggers[0].save_curves_png(str(tmp_path / "jax.png"))
    assert [c[0] for c in calls] == ["train_loss", "val_loss", "train_aa", "val_aa"]
    assert as_calls(loggers[1].curve_series()) == calls
    loggers[1].save_curves_png(str(tmp_path / "port.png"))
    assert Image.open(tmp_path / "port.png").size == tlog.FIGURE


def check_png(path, series):
    """Decode with PIL; each series' colour at each of its points within a
    pixel, unless a later series or the legend covers it there; every
    swatch in the legend; the axes box; the names in tEXt."""
    img = Image.open(path)
    assert img.size == tlog.FIGURE and img.mode == "RGB"
    assert img.text["legend"].splitlines() == [f"{s.key} {s.color} {s.axis}" for s in series]
    assert (img.text["x axis"], img.text["left axis"], img.text["right axis"]) == (
        "epoch", "loss", "Average Accuracy")
    rgb = np.asarray(img)
    left, top, right, bottom = tlog.AXES_BOX
    assert (rgb[top, left:right + 1] == 0).all() and (rgb[top:bottom + 1, left] == 0).all()
    (y0, y1, x0, x1), rows = tlog.legend_box(len(series))
    pixels = tlog.series_pixels(series)
    for k, (s, (px, py)) in enumerate(zip(series, pixels)):
        ok = {tlog.LETTER_RGB[s.color]} | {tlog.LETTER_RGB[t.color] for t in series[k + 1:]}
        for x, y in zip(np.rint(px).astype(int), np.rint(py).astype(int)):
            if y0 - 1 <= y <= y1 + 1 and x0 - 1 <= x <= x1 + 1:
                continue
            near = {tuple(v) for v in rgb[y - 1:y + 2, x - 1:x + 2].reshape(-1, 3)}
            assert tlog.LETTER_RGB[s.color] in near or near & ok - {tlog.LETTER_RGB[s.color]}, (
                s.key, x, y)
        assert tuple(rgb[rows[k], x1 - 10]) == tlog.LETTER_RGB[s.color]


@pytest.mark.parametrize("kind", ["finetune", "nine_series"])
def test_png_draws_each_series_at_its_points(kind, tmp_path):
    hist = HISTORIES[kind](np.random.default_rng(len(kind)))
    tlog.plot_history(str(tmp_path / "curves.png"), hist)
    check_png(tmp_path / "curves.png", tlog.curve_series(hist))


def test_finetune_writes_the_curves_of_jax_keys(tmp_path, monkeypatch):
    """A two-epoch port fine-tune writes ``finetune_curves.png``: the series
    of its history without the port's timing keys, which JAX's
    ``plot_history`` draws alike from the same history."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, gt = make_synthetic_scene(40, 37, bands=40, n_classes=4, seed=3)
        split = tsampling.dual_scene_split(scene, gt, 9, num=6, nc=32,
                                           rng=np.random.default_rng(1))
        mcfg = tcfg.preset("HSIMAE-S", embed_dim=32, num_heads=2, depth=3, s_depth=2,
                           decoder_dim=16, decoder_num_heads=2, decoder_depth=1,
                           compute_dtype=torch.float32)
        res = tft.dual_branch_finetune(split, mcfg, tcfg.FinetuneConfig(epochs=2, batch_size=8),
                                       workdir=str(tmp_path), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert set(tft.TIMING_KEYS) <= set(res.history)
    jax_keys = {k: v for k, v in res.history.items() if k not in tft.TIMING_KEYS}
    series = tlog.curve_series(jax_keys)
    assert [s.key for s in series] == ["loss", "loss_rec", "train_aa", "val_loss", "val_oa",
                                       "val_aa", "val_kappa"]
    check_png(tmp_path / "finetune_curves.png", series)
    calls = recorded_plots(monkeypatch)
    jlog.plot_history(str(tmp_path / "jax.png"), jax_keys)
    assert as_calls(series) == calls
