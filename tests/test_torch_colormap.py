"""Port parity for the classification colormaps: the palette and lookup of
``hsimae_tpu_torch.utils.colormap`` against ``hsimae_tpu.utils.colormap``,
and the port's own PNG writer against the file JAX's ``save_colormap``
writes through matplotlib (RGBA there, RGB here): the decoded RGB must be
equal, pixel for pixel."""

import ast
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hsimae_tpu.utils import colormap as jcm
from hsimae_tpu_torch.utils import colormap as tcm

REPO = Path(__file__).resolve().parents[1]


def test_palette_equal():
    np.testing.assert_array_equal(tcm._PALETTE, jcm._PALETTE)
    assert tcm._PALETTE.dtype == np.uint8 and tcm._PALETTE.shape == (20, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_label_to_colormap_equal(seed):
    label = np.random.default_rng(seed).integers(0, 20, (13, 7))
    got = tcm.label_to_colormap(label)
    np.testing.assert_array_equal(got, jcm.label_to_colormap(label))
    assert got.shape == (13, 7, 3) and got.dtype == np.uint8


def test_21_classes_raise_in_both():
    label = np.full((2, 2), 20)
    for mod in (tcm, jcm):
        with pytest.raises(AssertionError, match="20 classes"):
            mod.label_to_colormap(label)


def decoded_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("shape", [(9, 13), (16, 16), (1, 11), (11, 1), (1, 1)])
def test_png_decodes_to_jax_rgb(tmp_path, shape):
    label = np.random.default_rng(shape[0] * 31 + shape[1]).integers(0, 20, shape)
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    tcm.save_colormap(str(ours), label)
    jcm.save_colormap(str(theirs), label)
    got = decoded_rgb(ours)
    assert got.shape == shape + (3,)
    np.testing.assert_array_equal(got, decoded_rgb(theirs))
    np.testing.assert_array_equal(got, tcm._PALETTE[label])  # row 0 is the top row
    with Image.open(ours) as im:
        assert im.mode == "RGB" and im.format == "PNG"


def test_colormap_module_imports_no_matplotlib():
    tree = ast.parse((REPO / "hsimae_tpu_torch/utils/colormap.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not any(m.split(".")[0] in ("matplotlib", "PIL") for m in names), names
