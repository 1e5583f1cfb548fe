"""The port's quality panel, ``generate_chunked`` and the trainer's eval
cadence against the JAX package, on the CPU at the tiny geometry.

  * ``generate_chunked`` at n = 10 and 70 (chunk 64: 70 leaves a
    remainder), fed JAX's per-chunk draws (``fold_in(key, i)``), against
    the JAX function: 1e-4 absolute, the generator's parity tolerance.
  * The panel's scalars from the port's ``PanelRunner.metrics`` on those
    clips against the JAX ``PanelRunner`` with the same key, weights, pool
    and (bridged) extractor: ACD and SSIM 1e-5 absolute, dv_margin and
    gen_spread_ratio 1e-4 absolute, fvd_proxy 1e-3 relative.
  * The panel leaves the training state bit-identical.
  * The device-cached eval pool equals the JAX Trainer's (1e-6), and the
    host-fed pool takes eval_clips clips from the recent stacks.
  * Both training modes log the panel with the JAX record's keys.

The BN running stats are first warmed by train-mode passes of the port's
nets and G's output layer is scaled up, so that eval-mode generation is not
near-constant; the same weights and stats go to the JAX side.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mocogan_tpu.data import synthetic as jsynth
from mocogan_tpu.eval.panel import PanelRunner as JPanelRunner
from mocogan_tpu.models import generator as jgen
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.data import clips
from mocogan_tpu_torch.eval import panel as tpanel
from mocogan_tpu_torch.models import discriminators as tdisc
from mocogan_tpu_torch.models import generator as tgen
from mocogan_tpu_torch.ops import preproc
from mocogan_tpu_torch.train import state as tstate
from mocogan_tpu_torch.train.loop import Trainer, make_data_iterator
from test_torch_models import TINY, _latents, _t

torch.set_num_threads(1)

PANEL_KEYS = ("fvd_proxy", "gen_spread_ratio", "acd_gen", "acd_real",
              "gen_pairwise_ssim", "dv_margin", "fvd_proxy_dim",
              "eval_fingerprint", "eval_seconds")


def _cfg(**kw):
    return get_config("mug", **{**TINY, **kw})


@pytest.fixture(scope="module")
def nets(tiny_cfg):
    """(port state with warmed BN stats, JAX params, JAX bn) of one
    weight set. G's last deconv is scaled up so that its clips differ
    visibly from each other at init."""
    params = jax.tree.map(np.array, jstate_mod.create(tiny_cfg).params)
    params["gen"]["deconv3"]["w"] *= 20.0
    s = tstate.create(_cfg(), device="cpu")
    for name, net in s.nets.items():
        bridge.load_net(net, params[name])
    g, dv = s.nets["gen"], s.nets["dv"]
    real = torch.from_numpy(np.asarray(jsynth.make_batch(
        11, 8, t=8, size=32)[0]))
    with torch.no_grad():
        for i in range(30):
            lat = tgen.draw_latents(g.cfg, 8, 100, i, "cpu")
            tgen.sample_videos(g, lat["z_c"], lat["h0"], lat["eps"],
                               train=True)
            tdisc.video_apply(dv, real, train=True)
    bn = {n: bridge.bn_tree(net) for n, net in s.nets.items()}
    return s, params, bn


def _jax_chunk_draws(key, cfg, n, chunk=64):
    out, done, i = [], 0, 0
    while done < n:
        m = min(chunk, n - done)
        out.append(_t(_latents(jax.random.fold_in(key, i), cfg, m)))
        done, i = done + m, i + 1
    return out


@pytest.mark.parametrize("n", [10, 70])
def test_generate_chunked_matches_jax(nets, tiny_cfg, n):
    s, params, bn = nets
    key = jax.random.key(3)
    want = jgen.generate_chunked(params["gen"], bn["gen"], key, n,
                                 tiny_cfg.model)
    draws = _jax_chunk_draws(key, tiny_cfg, n)
    got = tgen.generate_chunked(s.nets["gen"], n, latents=draws)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    on_device = tgen.generate_chunked_device(s.nets["gen"], n, latents=draws)
    np.testing.assert_array_equal(on_device.numpy(), got)
    # without latents, chunk i draws (seed, step i): one chunk is generate
    np.testing.assert_array_equal(
        tgen.generate_chunked(s.nets["gen"], min(n, 64), seed=5),
        tgen.generate(s.nets["gen"], min(n, 64), seed=5).numpy())


@pytest.mark.parametrize("n", [10, 70])
def test_panel_matches_jax(nets, tiny_cfg, n):
    """n = 10: one generation chunk, one padded feature chunk; n = 70:
    64 + 6 clips, features padded 70 -> 96, D_V on 64 clips."""
    s, params, bn = nets
    pool, _ = jsynth.make_batch(7, n, t=8, size=32)
    key = jax.random.key(3)
    jrun = JPanelRunner(tiny_cfg)
    want = jrun(params, bn, pool, key, n=n)
    ext = bridge.fvd_extractor_from_jax(
        jax.tree.map(np.asarray, jrun.extractor.params))
    runner = tpanel.PanelRunner(_cfg(), extractor=ext, device="cpu")
    assert runner.fingerprint == jrun.fingerprint
    vids = tgen.generate_chunked_device(
        s.nets["gen"], n, latents=_jax_chunk_draws(key, tiny_cfg, n))
    raw = runner.metrics(vids, torch.from_numpy(np.asarray(pool)),
                         s.nets["dv"])
    got = tpanel.summarize(tpanel._to_host(raw))
    assert set(got) == set(want)
    assert want["gen_spread_ratio"] > 0.05      # not a collapsed generator
    for k, tol in (("acd_gen", 1e-5), ("acd_real", 1e-5),
                   ("gen_pairwise_ssim", 1e-5), ("dv_margin", 1e-4),
                   ("gen_spread_ratio", 1e-4)):
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert abs(got["fvd_proxy"] - want["fvd_proxy"]) \
        <= 1e-3 * abs(want["fvd_proxy"])


def test_panel_without_video_discriminator():
    cfg = _cfg(**{"model.use_video_discriminator": False})
    s = tstate.create(cfg, device="cpu")
    pool, _ = jsynth.make_batch(1, 8, t=8, size=32)
    out = tpanel.PanelRunner(cfg, device="cpu")(s.nets["gen"], None, pool,
                                                seed=0)
    assert "dv_margin" not in out
    assert set(out) == set(PANEL_KEYS[:5])
    assert np.isfinite(out["fvd_proxy"])


def test_panel_leaves_the_state_bit_identical(nets):
    s, _, _ = nets
    before = {(n, k): v.clone() for n, net in s.nets.items()
              for k, v in net.state_dict().items()}
    pool, _ = jsynth.make_batch(2, 12, t=8, size=32)
    runner = tpanel.PanelRunner(_cfg(), device="cpu")
    out = runner(s.nets["gen"], s.nets["dv"], pool, seed=4)
    assert all(np.isfinite(v) for v in out.values())
    after = {(n, k): v for n, net in s.nets.items()
             for k, v in net.state_dict().items()}
    assert set(after) == set(before)
    for key, v in before.items():
        assert torch.equal(v, after[key]), key
    assert all(p.grad is None for net in s.nets.values()
               for p in net.parameters())
    # a tensor pool gives the same panel as the numpy pool
    again = runner(s.nets["gen"], s.nets["dv"], torch.from_numpy(pool),
                   seed=4)
    assert again == out


# ---- the trainer -------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """5 clips of 40 px; lengths 12, 5, 9, 12, 3 (two shorter than T 8, so
    their windows wrap)."""
    d = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    for i, t in enumerate((12, 5, 9, 12, 3)):
        np.save(d / f"clip{i}.npy",
                rng.integers(0, 256, (t, 40, 40, 3), dtype=np.uint8))
    return str(d)


class _Stop(Exception):
    pass


def _capture_pool(monkeypatch, cls):
    seen = {}

    def spy(self, pool):
        seen["pool"] = np.asarray(pool)
        raise _Stop

    monkeypatch.setattr(cls, "eval_metrics", spy)
    return seen


def test_device_cached_eval_pool_matches_jax(store, tiny_cfg, tmp_path,
                                             monkeypatch):
    """The JAX Trainer's device-cached pool (its train step stubbed out:
    only the pool is compared) against the port Trainer's, on one store."""
    import dataclasses

    from mocogan_tpu.parallel import mesh as jmesh
    from mocogan_tpu.train.loop import Trainer as JTrainer

    jcfg = dataclasses.replace(
        tiny_cfg, train=dataclasses.replace(
            tiny_cfg.train, eval_every=1, eval_clips=16, sample_every=0,
            checkpoint_every=0),
        data=dataclasses.replace(tiny_cfg.data, dataset="npy_dir",
                                 data_dir=store, raw_size=40,
                                 device_cache=True))
    monkeypatch.setattr(jmesh, "make_cached_train_step",
                        lambda cfg, mesh, k: lambda st, *a: (st, {}))
    seen_j = _capture_pool(monkeypatch, JTrainer)
    with pytest.raises(_Stop):
        JTrainer(jcfg, out_dir=str(tmp_path / "jax")).run_device_cached(1)

    seen_t = _capture_pool(monkeypatch, Trainer)
    cfg = _cfg(**{"data.data_dir": store, "train.eval_every": 1,
                  "train.eval_clips": 16})
    tr = Trainer(cfg, out_dir=str(tmp_path / "port"), device="cpu")
    with pytest.raises(_Stop):
        tr.run_device_cached(1)
    assert seen_t["pool"].shape == seen_j["pool"].shape == (16, 8, 32, 32, 3)
    np.testing.assert_allclose(seen_t["pool"], seen_j["pool"], atol=1e-6,
                               rtol=0)
    assert tr.eval_pool_launches == 0          # the plain version on the CPU


# k, batch, eval_clips, feed -> the pool's clip count
@pytest.mark.parametrize("k, eval_clips, feed, want", [
    (1, 16, "synthetic", 16),     # the last ceil(16 / 8) = 2 batches
    (2, 12, "store", 12),         # the next stack of 2 x 8 raw clips
    (2, 40, "synthetic", 16)])    # all of one float stack
def test_host_fed_eval_pool(store, tmp_path, monkeypatch, k, eval_clips,
                            feed, want):
    seen = {}
    orig = Trainer.eval_metrics

    def spy(self, pool):
        seen["n"] = len(pool)
        seen["pool"] = pool
        return orig(self, pool)

    monkeypatch.setattr(Trainer, "eval_metrics", spy)
    cfg = _cfg(**{"data.dataset": "synthetic" if feed == "synthetic"
                  else "npy_dir", "data.data_dir": store,
                  "train.steps_per_call": k, "train.log_every": 2,
                  "train.eval_every": 2, "train.eval_clips": eval_clips,
                  "train.sample_every": 0, "train.checkpoint_every": 0})
    tr = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    it = (make_data_iterator(cfg) if feed == "synthetic" else
          clips.clip_batch_iterator(cfg, use_native=True))
    tr.run(it, total_steps=2 * k)
    assert seen["n"] == want
    assert tuple(seen["pool"].shape[1:]) == (8, 32, 32, 3)
    assert float(seen["pool"].abs().max()) <= 1.0


@pytest.mark.parametrize("mode", ["device-cached", "host-fed"])
def test_trainer_logs_the_panel(store, tmp_path, mode):
    cfg = _cfg(**{"data.data_dir": store, "train.steps_per_call": 2,
                  "train.log_every": 2, "train.eval_every": 4,
                  "train.eval_clips": 16, "train.sample_every": 0,
                  "train.checkpoint_every": 0})
    tr = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    before = preproc.LAUNCHES["resize_norm"]
    if mode == "host-fed":
        tr.run(clips.clip_batch_iterator(cfg, use_native=True), 6)
    else:
        tr.run_device_cached(6)
    assert preproc.LAUNCHES["resize_norm"] == before
    recs = [json.loads(x) for x in open(os.path.join(tmp_path, "log.jsonl"))]
    assert [r["step"] for r in recs] == [2, 4, 4, 6]
    ev = recs[2]
    assert set(PANEL_KEYS) <= set(ev)
    assert all(np.isfinite(ev[k]) for k in PANEL_KEYS
               if k != "eval_fingerprint")
    assert ev["fvd_proxy_dim"] == 64.0
    assert ev["eval_seconds"] == round(ev["eval_seconds"], 2)
    assert ev["eval_fingerprint"] == tr._panel.fingerprint
    assert not any(k.startswith("loss") for k in ev)
