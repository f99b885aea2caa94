"""Baseline model zoo: the JAX zoo's ten compared methods as torch modules.

Counterpart of ``hsimae_tpu/models/baselines``: the ten nets and SVM-RBF
(:mod:`.svm_rbf`, an RBF SVC of the port's own on the card). Every net
takes channels-last ``[B, h, w, bands]`` input, holds the reference torch
models' parameter names and shapes, and trains or evaluates
by ``module.train()`` / ``module.eval()`` (BatchNorm and dropout with
flax's semantics, :mod:`.common`).
"""

from hsimae_tpu_torch.models.baselines.ssrn import SSRN
from hsimae_tpu_torch.models.baselines.ssftt import SSFTT
from hsimae_tpu_torch.models.baselines.spectralformer import SpectralFormer
from hsimae_tpu_torch.models.baselines.dbda import DBDA
from hsimae_tpu_torch.models.baselines.fdssc import FDSSC
from hsimae_tpu_torch.models.baselines.rssan import RSSAN
from hsimae_tpu_torch.models.baselines.hybridformer import HybridFormer
from hsimae_tpu_torch.models.baselines.gscvit import GSCViT
from hsimae_tpu_torch.models.baselines.hit import HiT
from hsimae_tpu_torch.models.baselines.dctn import DCTN
from hsimae_tpu_torch.models.baselines.svm_rbf import SVMRBF

__all__ = [
    "SSRN", "SSFTT", "SpectralFormer", "DBDA", "FDSSC", "RSSAN",
    "HybridFormer", "GSCViT", "HiT", "DCTN", "SVMRBF",
]
