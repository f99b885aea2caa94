"""Smoke test for ``examples/quickstart_torch.py``, the port's documented
end-to-end path: pretrain -> fine-tune -> evaluate -> export -> serve on
the CPU, at a minimal budget, with one torch thread."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from hsimae_tpu_torch.utils import logger as tlog

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (six pytest workers share
    the machine's cores). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch_example", REPO / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_end_to_end(tmp_path):
    labels = load_quickstart().main(str(tmp_path), device="cpu", scenes=2, scene_size=32,
                                    pt_epochs=1, ft_epochs=2)
    # served labels: 1-based classes, background (0) excluded at argmax
    labels = np.asarray(labels)
    assert labels.shape == (5,) and labels.min() >= 1 and labels.max() <= 6
    for name in ("pt/params_final.pt", "ft/finetuned.pt", "ft/train_log.npy", "model.pt2",
                 "maps/scene_pred.png", "maps/scene_pred_masked.png",
                 "maps_artifact/scene_pred.png", "maps_artifact/scene_pred_masked.png"):
        assert (tmp_path / name).is_file(), name
    curves = Image.open(tmp_path / "ft" / "finetune_curves.png")
    assert curves.size == tlog.FIGURE
    legend = [line.split() for line in curves.text["legend"].splitlines()]
    assert [k for k, _, _ in legend] == ["loss", "loss_rec", "train_aa", "val_loss", "val_oa",
                                         "val_aa", "val_kappa"]
    colours = {tuple(v) for v in np.asarray(curves).reshape(-1, 3)}
    assert all(tlog.LETTER_RGB[c] in colours for _, c, _ in legend)
