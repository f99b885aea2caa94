"""Port parity for the baseline zoo's transformers (SSFTT, SpectralFormer,
HybridFormer, GSC-ViT) against ``hsimae_tpu.models.baselines``, on the CPU,
at the sizes of ``tests/test_baselines.py``: the checks of
``tests/test_torch_zoo_conv.py`` (every flax leaf covered through the JAX
converter, every port key read, eval logits at 2e-4, ``from_jax_zoo`` bit
for bit, one train-mode forward with all-keep dropout and the BatchNorm
statistics at 1e-5). SSFTT goes through its converter's c-major ->
s-major permutation of the Conv2d's input channels, SpectralFormer through
its CAF ``skipcat`` convs, GSC-ViT through ChanLayerNorm and
Conv1d-as-Dense."""

import pytest
import torch

from hsimae_tpu.models import baselines as jzoo
from hsimae_tpu.models.baselines import convert as jcvt
from hsimae_tpu_torch.models import baselines as tzoo
from test_torch_zoo_conv import CHECKS, Case, check_train_forward


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = dict(image_size=7, near_band=3, num_bands=64, num_classes=7)
HF = dict(image_size=15, patch_sizes=(3, 5), num_classes=7, channels=64)
CASES = [
    Case("SSFTT", lambda: jzoo.SSFTT(num_classes=7, kernel_2d=32, heads=4),
         lambda: tzoo.SSFTT(num_classes=7, kernel_2d=32, heads=4),
         lambda sd: jcvt.convert_ssftt(sd, kernel_3d=8), 13, 30),
    Case("SpectralFormer", lambda: jzoo.SpectralFormer(**SF), lambda: tzoo.SpectralFormer(**SF),
         jcvt.convert_spectralformer, 7, 64),
    Case("HybridFormer", lambda: jzoo.HybridFormer(**HF), lambda: tzoo.HybridFormer(**HF),
         jcvt.convert_hybridformer, 15, 64),
    Case("GSC-ViT", lambda: jzoo.GSCViT(num_classes=7, channels=64),
         lambda: tzoo.GSCViT(num_classes=7, channels=64), jcvt.convert_gscvit, 8, 64),
]


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_zoo_net_matches_jax(case, check):
    CHECKS[check](case)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_zoo_net_train_forward_matches_jax(case, monkeypatch):
    check_train_forward(case, monkeypatch)
