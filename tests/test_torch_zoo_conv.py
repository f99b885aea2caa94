"""Port parity for the baseline zoo's 3-D/2-D conv nets (SSRN, FDSSC, DBDA,
RSSAN) against ``hsimae_tpu.models.baselines``, on the CPU, at the sizes of
``tests/test_baselines.py``.

For each net, on one set of seeded weights (every zero-initialised tensor
and every BatchNorm statistic drawn again, so each path counts):

* the port's ``state_dict`` goes through the JAX package's own
  ``convert_<model>``; ``partial_restore`` into the flax model's variables
  covers every leaf of every collection and meets no unknown leaf (as
  ``tests/test_baseline_parity.py`` asserts against the reference), and a
  recording dict shows the converter read every port key;
* eval logits equal flax's on the same numpy input at rtol = atol = 2e-4
  (``test_baseline_parity.py``'s tolerance);
* ``from_jax_zoo(convert_<model>(sd))`` gives ``sd`` back bit for bit;
* one train-mode forward, dropout off on both sides (every element kept:
  injected all-keep masks in the port, ``flax.linen.Dropout`` monkeypatched
  to an all-keep mask in JAX, so both still scale by ``1 / (1 - rate)``),
  gives the same logits and the same updated BatchNorm statistics as flax's
  ``mutable=["batch_stats"]``, at 1e-5.

The other zoo files import this file's helpers.
"""

from typing import Callable, Dict, NamedTuple

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.checkpoints.io import partial_restore
from hsimae_tpu.models import baselines as jzoo
from hsimae_tpu.models.baselines import convert as jcvt
from hsimae_tpu_torch.models import baselines as tzoo
from hsimae_tpu_torch.models.baselines.common import all_keep, init_like_flax, set_dropout_masks
from hsimae_tpu_torch.models.baselines.convert import from_jax_zoo

N_BATCH = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (six pytest workers share
    the machine's cores; torch's default pool oversubscribes them).
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case(NamedTuple):
    name: str  # registry name, as from_jax_zoo takes it
    jax_model: Callable
    port_model: Callable
    convert: Callable  # the JAX package's converter: reference-named dict -> flax variables
    patch: int
    bands: int


class _Reading(dict):
    """A dict that records each key read through ``[]``."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def seeded_state(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``model`` initialised as flax does, then every all-zero tensor drawn
    from N(0, 0.1) and the BatchNorm statistics drawn (mean N(0, 0.1), var
    U(0.5, 1.5)); loaded into ``model`` and returned (cloned)."""
    init_like_flax(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().clone()
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("running_mean") or not torch.any(v):
            v = torch.randn(v.shape, generator=g) * 0.1
        sd[k] = v
    model.load_state_dict(sd, strict=True)
    return sd


class Built(NamedTuple):
    model: torch.nn.Module
    sd: Dict[str, torch.Tensor]
    read: set
    converted: dict
    restored: dict
    x: np.ndarray


_BUILT: Dict[str, Built] = {}


def build(case: Case) -> Built:
    """The port net with seeded weights, its state converted by the JAX
    converter (keys read recorded) and restored into flax variables whose
    structure comes from ``jax.eval_shape`` of the flax init (cached per
    net for the module)."""
    if case.name not in _BUILT:
        model = case.port_model()
        sd = seeded_state(model)
        rec = _Reading(sd)
        converted = case.convert(rec)
        x = np.random.default_rng(0).standard_normal(
            (N_BATCH, case.patch, case.patch, case.bands)).astype(np.float32)
        jm = case.jax_model()
        shapes = jax.eval_shape(lambda v: jm.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, v, False),
            jnp.asarray(x))
        restored = {}
        for col, tree in shapes.items():
            template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
            restored[col] = (template, *partial_restore(template, converted.get(col, {}),
                                                        verbose=False))
        _BUILT[case.name] = Built(model, sd, set(rec.read), converted, restored, x)
    return _BUILT[case.name]


def variables(b: Built) -> dict:
    return {col: r[1] for col, r in b.restored.items()}


def check_converter_covers_every_leaf(case: Case):
    b = build(case)
    assert set(b.converted) == set(b.restored), "collections differ"
    for col, (template, _, loaded, skipped) in b.restored.items():
        n = len(jax.tree_util.tree_leaves(template))
        assert len(loaded) == n, f"{col}: loaded {len(loaded)}/{n} leaves; unmapped: {skipped}"
        assert not skipped, f"{col}: the converter produced unknown leaves {skipped}"


def check_converter_reads_every_port_key(case: Case):
    b = build(case)
    assert b.read == set(b.sd), f"never read: {sorted(set(b.sd) - b.read)}"


def check_eval_logits(case: Case):
    b = build(case)
    jm = case.jax_model()
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(variables(b), b.x))
    b.model.eval()
    with torch.no_grad():
        got = b.model(torch.from_numpy(b.x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def check_round_trip(case: Case):
    b = build(case)
    back = from_jax_zoo(case.name, b.converted)
    assert set(back) == set(b.sd)
    for k, v in b.sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # and it loads by name and shape
    case.port_model().load_state_dict(back, strict=True)


def _keep_all(self, inputs, deterministic=None, rng=None):
    """flax ``Dropout`` with a mask that keeps every element."""
    det = self.deterministic if deterministic is None else deterministic
    return inputs if det or self.rate == 0.0 else inputs / (1.0 - self.rate)


def check_train_forward(case: Case, monkeypatch):
    """One train-mode forward with dropout off: logits and the updated
    BatchNorm statistics against flax's ``mutable=["batch_stats"]``."""
    b = build(case)
    monkeypatch.setattr(fnn.Dropout, "__call__", _keep_all)
    jm = case.jax_model()
    vs = variables(b)
    mutable = ["batch_stats"] if "batch_stats" in vs else []
    out = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=mutable))(vs, b.x)
    ref, new_vars = out if isinstance(out, tuple) else (out, {})
    model = case.port_model()
    model.load_state_dict(b.sd)
    set_dropout_masks(model, all_keep)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(b.x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    if mutable:
        stats = case.convert(model.state_dict())["batch_stats"]
        flat_ref = jax.tree_util.tree_leaves_with_path(new_vars["batch_stats"])
        flat_got = dict(jax.tree_util.tree_leaves_with_path(stats))
        assert len(flat_ref) == len(flat_got)
        for path, leaf in flat_ref:
            np.testing.assert_allclose(flat_got[path], np.asarray(leaf), rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))


CHECKS = {
    "covers_every_flax_leaf": check_converter_covers_every_leaf,
    "reads_every_port_key": check_converter_reads_every_port_key,
    "eval_logits": check_eval_logits,
    "from_jax_zoo_round_trip": check_round_trip,
}

CASES = [
    Case("SSRN", lambda: jzoo.SSRN(bands=64, num_classes=7),
         lambda: tzoo.SSRN(bands=64, num_classes=7), jcvt.convert_ssrn, 9, 64),
    Case("FDSSC", lambda: jzoo.FDSSC(bands=64, num_classes=7),
         lambda: tzoo.FDSSC(bands=64, num_classes=7), jcvt.convert_fdssc, 9, 64),
    Case("DBDA", lambda: jzoo.DBDA(bands=64, num_classes=7),
         lambda: tzoo.DBDA(bands=64, num_classes=7), jcvt.convert_dbda, 9, 64),
    Case("RSSAN", lambda: jzoo.RSSAN(bands=64, num_classes=7),
         lambda: tzoo.RSSAN(bands=64, num_classes=7), jcvt.convert_rssan, 9, 64),
]


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_zoo_net_matches_jax(case, check):
    CHECKS[check](case)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_zoo_net_train_forward_matches_jax(case, monkeypatch):
    check_train_forward(case, monkeypatch)
