"""Port parity for the multi-seed protocol: ``hsimae_tpu_torch.train.protocol``
against ``hsimae_tpu.train.protocol`` and the fine-tune CLI's
``--protocol`` line against JAX's.

Both packages' ``_run_one`` are replaced by one deterministic fake (metrics
made from ``(lr, seed)``, two lrs tied, per-class vectors of two widths), so
the selection, the tie rule, the statistics, the padding and the resume
records are held exactly. Then the port runs a real micro protocol on the
CPU (HSIMAE-S cut to depth 2, width 32, 2 heads; 2 lrs, 1 selection seed,
2 test seeds, 2 epochs), is killed in its fourth run and resumes, and
leaves the shared pretrained weights as they were."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.train import protocol as jp
from hsimae_tpu.utils import metrics as jmetrics
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.train import protocol as tp
from hsimae_tpu_torch.utils import metrics as tmetrics

# val score by lr: 1e-3 and 5e-4 tie at the top, so the first in grid order wins
SCORE = {5e-3: 0.61, 1e-3: 0.83, 5e-4: 0.83, 1e-4: 0.52}
MICRO = dict(depth=2, s_depth=1, decoder_depth=1, embed_dim=32, num_heads=2, decoder_dim=16,
             decoder_num_heads=2)


def fake_run_one(metrics_cls, calls, die_after=None):
    """A stand-in for ``_run_one`` of either package."""

    def fake(scene_raw, gt, model_cfg, ft_cfg, seed, samples_per_class, pretrained, gwpca,
             evaluate, eval_cfg, device=None):
        if die_after is not None and len(calls) >= die_after:
            raise KeyboardInterrupt("simulated preemption")
        calls.append((ft_cfg.lr, seed, evaluate))
        v = SCORE[ft_cfg.lr] + 0.01 * (seed - 3408)  # symmetric over the 3 selection seeds
        val = metrics_cls(oa=v, aa=v - 0.02, kappa=v - 0.04, per_class=np.full(3, v))
        test = None
        if evaluate:
            r = np.random.default_rng(seed)
            width = 3 + seed % 2  # a run that saw fewer classes has a shorter vector
            test = metrics_cls(oa=float(r.random()), aa=float(r.random()),
                               kappa=float(r.random()), per_class=r.random(width))
        return val, test

    return fake


def assert_results_equal(got, want):
    assert got.best_lr == want.best_lr
    assert got.selection_scores == want.selection_scores
    for f in ("oa_mean", "oa_std", "aa_mean", "aa_std", "kappa_mean", "kappa_std"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.per_class_mean, want.per_class_mean)
    assert len(got.test_metrics) == len(want.test_metrics)
    for a, b in zip(got.test_metrics, want.test_metrics):
        assert (a.oa, a.aa, a.kappa) == (b.oa, b.aa, b.kappa)
        np.testing.assert_array_equal(a.per_class, b.per_class)


def run_both(monkeypatch, **proto):
    jcalls, tcalls = [], []
    monkeypatch.setattr(jp, "_run_one", fake_run_one(jmetrics.Metrics, jcalls))
    monkeypatch.setattr(tp, "_run_one", fake_run_one(tmetrics.Metrics, tcalls))
    scene, gt = np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.int32)
    want = jp.run_protocol(scene, gt, jcfg.preset("HSIMAE-S"), proto=jcfg.ProtocolConfig(**proto),
                           verbose=False)
    got = tp.run_protocol(scene, gt, tcfg.preset("HSIMAE-S"), proto=tcfg.ProtocolConfig(**proto),
                          verbose=False, device="cpu")
    return got, want, tcalls, jcalls


@pytest.mark.parametrize("proto", [{}, dict(lr_grid=(1e-4, 5e-3), selection_seeds=2,
                                            test_seeds=3)], ids=["default", "small"])
def test_same_runs_same_result(monkeypatch, proto):
    got, want, tcalls, jcalls = run_both(monkeypatch, **proto)
    assert tcalls == jcalls
    assert_results_equal(got, want)
    if not proto:
        assert got.best_lr == 1e-3  # the tie with 5e-4 goes to the first in grid order
        assert len(tcalls) == 4 * 3 + 5 and got.per_class_mean.shape == (4,)
        assert got.oa_std == float(np.std([m.oa for m in got.test_metrics]))  # ddof 0


def test_port_resumes_a_jax_written_protocol(monkeypatch, tmp_path):
    scene, gt = np.zeros((4, 4, 3), np.float32), np.ones((4, 4), np.int32)
    want, _, _, _ = run_both(monkeypatch)
    wd = str(tmp_path)
    jcalls = []
    monkeypatch.setattr(jp, "_run_one", fake_run_one(jmetrics.Metrics, jcalls, die_after=14))
    with pytest.raises(KeyboardInterrupt):
        jp.run_protocol(scene, gt, jcfg.preset("HSIMAE-S"), verbose=False, resume_dir=wd)
    records = [json.loads(line) for line in open(tmp_path / "protocol_runs.jsonl")]
    assert len(records) == 14 and [r["stage"] for r in records[-2:]] == ["test", "test"]
    tcalls = []
    monkeypatch.setattr(tp, "_run_one", fake_run_one(tmetrics.Metrics, tcalls))
    got = tp.run_protocol(scene, gt, tcfg.preset("HSIMAE-S"), verbose=False, resume_dir=wd,
                          device="cpu")
    assert tcalls == [(1e-3, 3409, True), (1e-3, 3410, True), (1e-3, 3411, True)]
    assert_results_equal(got, want)
    assert len(open(tmp_path / "protocol_runs.jsonl").readlines()) == 17


def test_cli_protocol_line_equals_jax(monkeypatch, tmp_path, capsys):
    from hsimae_tpu.cli import finetune as jcli
    from hsimae_tpu_torch.cli import finetune as tcli

    monkeypatch.setattr(jp, "_run_one", fake_run_one(jmetrics.Metrics, []))
    monkeypatch.setattr(tp, "_run_one", fake_run_one(tmetrics.Metrics, []))
    argv = ["--synthetic", "--synthetic-size", "12", "--synthetic-bands", "40",
            "--synthetic-classes", "3", "--model", "HSIMAE-S", "--protocol",
            "--lr-grid", "5e-3", "5e-4", "1e-3", "--selection-seeds", "2", "--test-seeds", "4"]
    jcli.main(argv + ["--workdir", str(tmp_path / "jax")])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    res = tcli.main(argv + ["--workdir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(got)) == {"best_lr", "oa", "aa", "kappa", "per_class"}
    assert got == want and res.best_lr == 5e-4
    assert (open(tmp_path / "port" / "protocol_runs.jsonl").read()
            == open(tmp_path / "jax" / "protocol_runs.jsonl").read())


@pytest.fixture(scope="module")
def micro():
    scene, gt = make_synthetic_scene(20, 20, bands=40, n_classes=3, seed=4)
    cfg = tcfg.preset("HSIMAE-S", **MICRO)
    pretrained = th.build_hsimae(cfg, seed=11, device="cpu").state_dict()
    kw = dict(ft_cfg=tcfg.FinetuneConfig(epochs=2, batch_size=8),
              proto=tcfg.ProtocolConfig(lr_grid=(1e-3, 1e-4), selection_seeds=1, test_seeds=2),
              samples_per_class=5, pretrained=pretrained, gwpca=True, verbose=False,
              device="cpu")
    before = {k: v.clone() for k, v in pretrained.items()}
    full = tp.run_protocol(scene, gt, cfg, **kw)
    return scene, gt, cfg, kw, before, full


def test_run_protocol_micro(micro):
    _, _, _, kw, before, res = micro
    assert res.best_lr in (1e-3, 1e-4)
    assert set(res.selection_scores) == {1e-3, 1e-4}
    assert len(res.test_metrics) == 2
    for m in res.test_metrics:
        assert 0.0 <= m.oa <= 1.0 and 0.0 <= m.aa <= 1.0 and -1.0 <= m.kappa <= 1.0
    assert 0.0 <= res.oa_mean <= 1.0 and np.isfinite(res.oa_std)
    assert res.per_class_mean.shape[0] >= 3 - 1
    # the shared pretrained weights are untouched by four fine-tunes
    after = kw["pretrained"]
    assert set(after) == set(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k


def test_port_resumes_after_kill(micro, monkeypatch, tmp_path):
    scene, gt, cfg, kw, _, full = micro
    real = tp._run_one
    calls = []

    def dying(*a, **k):
        calls.append(a[4])
        if len(calls) == 4:
            raise KeyboardInterrupt("simulated preemption")
        return real(*a, **k)

    monkeypatch.setattr(tp, "_run_one", dying)
    with pytest.raises(KeyboardInterrupt):
        tp.run_protocol(scene, gt, cfg, resume_dir=str(tmp_path), **kw)
    lines = (tmp_path / "protocol_runs.jsonl").read_text().splitlines()
    assert len(lines) == 3
    with open(tmp_path / "protocol_runs.jsonl", "a") as f:
        f.write('{"stage": "test", "lr": ')  # a kill mid-append
    calls.clear()
    monkeypatch.setattr(tp, "_run_one", lambda *a, **k: (calls.append(a[4]), real(*a, **k))[1])
    res = tp.run_protocol(scene, gt, cfg, resume_dir=str(tmp_path), **kw)
    assert calls == [3408]  # only the second test seed runs again
    lines = (tmp_path / "protocol_runs.jsonl").read_text().splitlines()
    assert len(lines) == 5 and json.loads(lines[4])["seed"] == 3408  # not glued to the torn line
    assert_results_equal(res, full)
    assert dataclasses.asdict(res.test_metrics[0]).keys() == {"oa", "aa", "kappa", "per_class"}
