"""Restoring weights into the port's classifier, and its seeded init, on the
CPU: a state dict restores by key and shape, as the JAX package's
``partial_restore`` does (a head with another class count is ignored, so an
uncovered ``cls_head`` raises; any other tensor of another shape warns and
the rest loads), and with ``trunc_init=False`` the patch projection draws
xavier over the fans of JAX's Dense kernel ``[u*p*p, C]``."""

import math

import pytest
import torch

from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.train import evaluate as tev


def test_state_dict_of_another_class_count_raises_the_cls_head_error():
    cfg = tcfg.preset("HSIMAE-S")
    five = tev.build_classifier(None, cfg, 5, device="cpu", seed=0).state_dict()
    with pytest.raises(ValueError, match="do not cover cls_head"):
        tev.build_classifier(five, cfg, 7, device="cpu")


def test_tensor_of_another_shape_warns_and_the_rest_loads():
    cfg = tcfg.preset("HSIMAE-S")
    src = tev.build_classifier(None, cfg, 5, device="cpu", seed=1).state_dict()
    bad = "blocks_1.0.attn.q.weight"
    src[bad] = torch.zeros(3, 3)
    with pytest.warns(UserWarning, match="1 parameters stay at their seeded init"):
        model = tev.build_classifier(src, cfg, 5, device="cpu", seed=2)
    got = model.state_dict()
    seeded = th.build_hsi_vit(cfg, 5, seed=2, device="cpu").state_dict()
    assert torch.equal(got[bad], seeded[bad])
    for k, v in src.items():
        if k != bad:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["HSIMAE-S", "HSIMAE-B"])
def test_xavier_patch_embed_bound_is_the_dense_kernels(name):
    cfg = tcfg.preset(name, trunc_init=False)
    w = th.build_hsi_vit(cfg, 5, seed=0, device="cpu").patch_embed.proj.weight
    c, fan_in = w.shape[0], w[0].numel()
    assert fan_in == cfg.b_patch_size * cfg.patch_size ** 2
    bound = math.sqrt(6.0 / (fan_in + c))
    top = w.abs().max().item()
    assert 0.9 * bound < top <= bound
