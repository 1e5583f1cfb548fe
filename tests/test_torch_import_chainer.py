"""The port's Chainer checkpoint importer against the JAX package's, at the
tiny test geometry (32x32x8 frames, widths 8) and its categorical variant
(4 classes).

Both packages map the same npz files; the trees, reports and exports must
be bit-equal (the port keeps its own numpy copy of the spec and the same
float32 sums). Through ``bridge.load_net`` the imported torch weights then
equal the source state exactly, the deconv kernels equal the npz's
``dc{i}/W`` (the JAX layout's flip and ``Deconv2d``'s flip back cancel).
Clips of a hand-written Chainer generator agree with JAX's within the
generator tests' 1e-4 (``tests/test_torch_models.py``).
"""

import jax
import numpy as np
import pytest
import torch

from mocogan_tpu.eval import import_chainer as jimp
from mocogan_tpu.models import generator as jgen
from mocogan_tpu.ops.layers import out_size_up
from mocogan_tpu.train import state as jstate_mod
from mocogan_tpu.utils import prng as jprng
from mocogan_tpu_torch import bridge, get_config
from mocogan_tpu_torch.eval import import_chainer as timp
from mocogan_tpu_torch.eval import parity
from mocogan_tpu_torch.models import generator as tgen
from mocogan_tpu_torch.train import state as tstate

torch.set_num_threads(1)

TINY = {"model.image_size": 32, "model.video_length": 8,
        "model.gen_features": 8, "model.disc_features": 8,
        "train.batch_size": 8, "train.steps_per_call": 1,
        "data.device_cache": False}
CAT = {**TINY, "model.n_classes": 4}
ATOL = 1e-4
NETS = [("mug", "gen"), ("mug", "di"), ("mug", "dv"),
        ("categorical", "gen"), ("categorical", "dv")]


def _tcfg(name):
    return get_config(name, **(CAT if name == "categorical" else TINY))


@pytest.fixture(scope="module")
def jstates(tiny_cfg, tiny_cat_cfg):
    """{config name: (JAX config, numpy params, numpy bn)}."""
    out = {}
    for name, cfg in (("mug", tiny_cfg), ("categorical", tiny_cat_cfg)):
        s = jstate_mod.create(cfg, seed=3)
        out[name] = (cfg, jax.tree.map(np.array, s.params),
                     jax.tree.map(np.array, s.bn))
    return out


def _leaves(tree, prefix=""):
    """{"a/b/c": array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_export(tmp_path, jstates, cfg_name, net):
    cfg, params, bn = jstates[cfg_name]
    path = str(tmp_path / f"{cfg_name}_{net}.npz")
    jimp.export_net_npz(path, net, params[net], bn[net], cfg.model)
    return path


@pytest.mark.parametrize("cfg_name,net", NETS)
def test_import_matches_jax(jstates, tmp_path, cfg_name, net):
    """The JAX export of a JAX state, imported by both packages: the same
    trees bit for bit, and the same report."""
    path = _jax_export(tmp_path, jstates, cfg_name, net)
    cfg, params, bn = jstates[cfg_name]
    jp, jb, jrep = jimp.import_net_npz(path, net, cfg.model)
    tp, tb, trep = timp.import_net_npz(path, net, _tcfg(cfg_name).model)
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(tb, jb)
    _assert_trees_equal(tp, params[net])
    assert trep == jrep


@pytest.mark.parametrize("cfg_name,net", NETS)
def test_export_matches_jax(jstates, tmp_path, cfg_name, net):
    """The port's export of a torch net holding the JAX state equals the
    JAX export key by key, bit for bit; importing it into a fresh port
    state gives back every parameter and BN buffer exactly, with the
    deconv kernels equal to the npz's dc{i}/W."""
    want_path = _jax_export(tmp_path, jstates, cfg_name, net)
    _, params, bn = jstates[cfg_name]
    cfg = _tcfg(cfg_name)
    src = tstate.create(cfg, seed=11, device="cpu")
    bridge.load_net(src.nets[net], params[net], bn[net])
    paths = timp.export_state(src, str(tmp_path / "port"))
    with np.load(paths[net]) as got, np.load(want_path) as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        npz = dict(got)

    state, reports = timp.import_experiment(cfg, **{f"{net}_npz":
                                                    paths[net]},
                                            device="cpu")
    assert not reports[net]["missing"] and not reports[net]["unused"]
    for (k, a), (k2, b) in zip(src.nets[net].state_dict().items(),
                               state.nets[net].state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    if net == "gen":
        for i in range(4):
            w = getattr(state.nets["gen"], f"deconv{i}").w.detach()
            np.testing.assert_array_equal(w.numpy(), npz[f"dc{i}/W"])
    # a net that was not imported keeps the fresh state's values
    fresh = tstate.create(cfg, seed=cfg.train.seed, device="cpu")
    for other, module in state.nets.items():
        if other != net:
            for a, b in zip(module.parameters(),
                            fresh.nets[other].parameters()):
                assert torch.equal(a, b)
    assert all(not opt.state for opt in state.opt.values())
    assert state.step == 0


def _chainer_generator_npz(path, m):
    """A generator npz written from scratch in Chainer naming and shapes,
    with pre-BN biases and BN counters (as tests/test_import_chainer.py)."""
    ngf = m.gen_features
    s0 = out_size_up(m.image_size, 4)
    widths = [ngf * 8, ngf * 4, ngf * 2, ngf]
    rng = np.random.default_rng(7)

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    entries = {}
    for g, dim in [("W_r", m.dim_eps), ("W_z", m.dim_eps), ("W", m.dim_eps),
                   ("U_r", m.dim_motion), ("U_z", m.dim_motion),
                   ("U", m.dim_motion)]:
        entries[f"gru/{g}/W"] = n(m.dim_motion, dim)
        entries[f"gru/{g}/b"] = n(m.dim_motion)
    entries["fc/W"] = n(widths[0] * s0 * s0, m.dim_z)
    entries["fc/b"] = n(widths[0] * s0 * s0)
    for bn_name, c in [("bn_fc", widths[0]), ("bn0", widths[1]),
                       ("bn1", widths[2]), ("bn2", widths[3])]:
        entries[f"{bn_name}/gamma"] = 1 + 0.1 * n(c)
        entries[f"{bn_name}/beta"] = n(c)
        entries[f"{bn_name}/avg_mean"] = n(c)
        entries[f"{bn_name}/avg_var"] = 1 + 0.1 * np.abs(n(c))
        entries[f"{bn_name}/N"] = np.zeros((), np.int32)
    cin = widths[0]
    for i in range(4):
        cout = m.channels if i == 3 else widths[i + 1]
        entries[f"dc{i}/W"] = n(cin, cout, 4, 4)
        entries[f"dc{i}/b"] = n(cout)
        cin = cout
    np.savez(path, **entries)
    return entries


def test_hand_written_chainer_generator_matches_jax(tiny_cfg, tmp_path):
    """A Chainer-convention generator npz through both packages: the same
    absorbed biases and trees, and the same clips from the same draws."""
    path = str(tmp_path / "gen_chainer.npz")
    entries = _chainer_generator_npz(path, tiny_cfg.model)
    jp, jb, jrep = jimp.import_net_npz(path, "gen", tiny_cfg.model)
    cfg = _tcfg("mug")
    state, reports = timp.import_experiment(cfg, gen_npz=path, device="cpu")
    assert reports["gen"] == jrep
    assert {a["key"] for a in jrep["absorbed"]} >= {"fc/b", "dc0/b", "dc1/b",
                                                    "dc2/b"}
    g = state.nets["gen"]
    _assert_trees_equal(bridge.params_tree(g), jp)
    _assert_trees_equal(bridge.bn_tree(g), jb)
    for i in range(4):
        np.testing.assert_array_equal(
            getattr(g, f"deconv{i}").w.detach().numpy(), entries[f"dc{i}/W"])

    key = jax.random.key(0)
    want = np.asarray(jgen.generate(jax.tree.map(jax.numpy.asarray, jp),
                                    jax.tree.map(jax.numpy.asarray, jb), key,
                                    2, tiny_cfg.model))
    m = tiny_cfg.model
    normal = jax.random.normal
    lat = {"z_c": normal(jprng.role_key(key, "content"), (2, m.dim_content)),
           "h0": normal(jprng.role_key(key, "motion_init"),
                        (2, m.dim_motion)),
           "eps": normal(jprng.role_key(key, "motion_noise"),
                         (m.video_length, 2, m.dim_eps))}
    got = tgen.generate(g, 2, latents={k: torch.from_numpy(np.array(v))
                                       for k, v in lat.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert parity.video_digest(tgen.generate(g, 2, seed=0)) == \
        parity.video_digest(tgen.generate(g, 2, seed=0))


def test_rename_and_strict_reports_match_jax(jstates, tmp_path):
    """A renamed key and a wrong shape: both packages refuse a strict
    import, and report the same per-tensor problems with --rename and
    strict=False."""
    path = _jax_export(tmp_path, jstates, "mug", "di")
    data = dict(np.load(path))
    data["conv_first/W"] = data.pop("c0/W")
    data["fc/W"] = data["fc/W"][:, :5]
    bad = str(tmp_path / "di2.npz")
    np.savez(bad, **data)
    m_j, m_t = jstates["mug"][0].model, _tcfg("mug").model
    for imp, m in ((jimp, m_j), (timp, m_t)):
        with pytest.raises(ValueError, match="import incomplete"):
            imp.import_net_npz(bad, "di", m)
    reports = [imp.import_net_npz(bad, "di", m, strict=False)[2]
               for imp, m in ((jimp, m_j), (timp, m_t))]
    assert reports[0] == reports[1]
    assert "conv_first/W" in reports[1]["unused"]
    rename = {"conv_first/W": "c0/W"}
    (jp, _, jrep), (tp, _, trep) = [
        imp.import_net_npz(bad, "di", m, rename=rename, strict=False)
        for imp, m in ((jimp, m_j), (timp, m_t))]
    assert trep == jrep and "c0/W" in trep["matched"]
    assert any(r["key"] == "fc/W" for r in trep["shape_mismatch"])
    _assert_trees_equal(tp, jp)


def test_partial_import_merges_over_random_init(jstates, tmp_path):
    """strict=False: tensors missing from the npz keep the port's random
    init (create()'s values), the rest are imported, and the generator
    still runs."""
    path = _jax_export(tmp_path, jstates, "mug", "gen")
    raw = dict(np.load(path))
    dropped = [k for k in raw if k.startswith("dc3/")]
    assert dropped
    for k in dropped:
        del raw[k]
    partial = str(tmp_path / "gen_partial.npz")
    np.savez(partial, **raw)
    cfg = _tcfg("mug")
    with pytest.raises(ValueError, match="incomplete"):
        timp.import_experiment(cfg, gen_npz=partial, device="cpu")
    state, reports = timp.import_experiment(cfg, gen_npz=partial,
                                            strict=False, device="cpu")
    _, jrep = jimp.import_experiment(jstates["mug"][0], gen_npz=partial,
                                     strict=False)
    assert reports == jrep
    assert {r["key"] for r in reports["gen"]["missing"]} == set(dropped)
    g, fresh = state.nets["gen"], tstate.create(cfg, device="cpu")
    for name in ("w", "b"):
        assert torch.equal(getattr(g.deconv3, name),
                           getattr(fresh.nets["gen"].deconv3, name))
    want = jstates["mug"][1]["gen"]
    tree = bridge.params_tree(g)
    for layer in ("fc", "deconv0", "gru", "bn_fc"):
        _assert_trees_equal(tree[layer], want[layer])
    v = tgen.generate(g, 2, seed=0)
    assert torch.isfinite(v).all()


def _snapshot(tmp_path, jstates, names, noise=True):
    entries = {}
    for net, gname in names.items():
        for k, v in np.load(_jax_export(tmp_path, jstates, "mug",
                                        net)).items():
            entries[f"updater/model:{gname}/{k}"] = v
            if noise:
                entries[f"updater/optimizer:{gname}/{k}/m"] = (
                    np.zeros_like(v))
    if noise:
        entries["updater/iteration"] = np.asarray(12345)
        entries["extensions/LogReport/_log"] = np.asarray(0)
    path = str(tmp_path / f"snap_{'_'.join(names.values())}.npz")
    np.savez(path, **entries)
    return path


@pytest.mark.parametrize("names", [
    {"gen": "gen", "di": "image_dis", "dv": "video_dis"},
    {"gen": "g_gen", "di": "i_dis", "dv": "v_dis"}])
def test_split_trainer_snapshot_matches_jax(jstates, tmp_path, names):
    """Long group names with optimizer and iterator noise, and short
    tokens ('v_dis' is D_V, not D_I): the same split as JAX, and a
    snapshot import equal to JAX's reports and to the per-net state."""
    snap = _snapshot(tmp_path, jstates, names)
    jnets, jrep = jimp.split_trainer_snapshot(snap)
    tnets, trep = timp.split_trainer_snapshot(snap)
    assert trep == jrep and trep["groups"] == names
    assert set(tnets) == set(jnets) == {"gen", "di", "dv"}
    for net in tnets:
        _assert_trees_equal(tnets[net], jnets[net])

    cfg = _tcfg("mug")
    state, reports = timp.import_experiment(cfg, snapshot_npz=snap,
                                            device="cpu")
    _, jreports = jimp.import_experiment(jstates["mug"][0],
                                         snapshot_npz=snap)
    assert reports == jreports
    _, params, bn = jstates["mug"]
    for net, module in state.nets.items():
        _assert_trees_equal(bridge.params_tree(module), params[net])
        _assert_trees_equal(bridge.bn_tree(module), bn[net])


def test_split_trainer_snapshot_errors(jstates, tmp_path):
    """Two groups on one net, and a file with no model group, raise in
    both packages with the same message."""
    dup = _snapshot(tmp_path, jstates, {"gen": "gen"}, noise=False)
    entries = dict(np.load(dup))
    entries.update({k.replace("model:gen/", "model:generator2/"): v
                    for k, v in list(entries.items())})
    dpath = str(tmp_path / "dup.npz")
    np.savez(dpath, **entries)
    flat = str(tmp_path / "flat.npz")
    np.savez(flat, **{"dc0/W": np.zeros((2, 2, 4, 4), np.float32)})
    for path, match in ((dpath, "two groups"), (flat, "model:")):
        msgs = []
        for imp in (jimp, timp):
            with pytest.raises(ValueError, match=match) as e:
                imp.split_trainer_snapshot(path)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_import_experiment_refuses_an_absent_net(jstates, tmp_path):
    """A snapshot's D_V for a config without D_V raises, as in JAX."""
    snap = _snapshot(tmp_path, jstates, {"gen": "gen", "dv": "video_dis"})
    cfg = get_config("mug", **{**TINY,
                               "model.use_video_discriminator": False})
    with pytest.raises(ValueError, match="does not instantiate"):
        timp.import_experiment(cfg, snapshot_npz=snap, device="cpu")


def test_import_cli_and_parity_reference_npz(tmp_path, capsys):
    """The import CLI's --digest and the parity CLI's --reference-npz give
    the digest of the exported generator's own generate(); --rename adapts
    a renamed key in both (the toy config: the CLIs take named configs)."""
    cfg = get_config("toy")
    src = tstate.create(cfg, seed=4, device="cpu")
    path = timp.export_state(src, str(tmp_path / "exp"))["gen"]
    raw = dict(np.load(path))
    raw["deconv_out/W"] = raw.pop("dc3/W")
    renamed = str(tmp_path / "gen_renamed.npz")
    np.savez(renamed, **raw)
    common = ["--config", "toy", "--n", "2", "--seed", "1", "--device",
              "cpu", "--rename", "deconv_out/W=dc3/W"]
    want = parity.check_determinism(src.nets["gen"], n=2, seed=1)["digest"]

    out = timp.main(["--gen-npz", renamed, "--digest", *common])
    printed = capsys.readouterr().out
    assert out["digest"] == want and want in printed
    assert "[gen] 34 tensors matched, 0 problems, 0 unused npz keys" \
        in printed
    assert "dc3/W" in out["reports"]["gen"]["matched"]

    rep = parity.main(["--reference-npz", renamed, *common])
    assert rep["digest"] == want and rep["deterministic"]
    assert "[parity] imported generator" in capsys.readouterr().out
    with pytest.raises(ValueError, match="import incomplete"):
        parity.main(["--reference-npz", renamed, *common[:-2]])
