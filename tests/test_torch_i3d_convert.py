"""The port's kinetics-i3d checkpoint converter against the JAX package's.

A synthetic TF-v1 Saver checkpoint with the public checkpoint's variable
names and shapes (Sonnet layout: DHWIO conv kernels, (1,1,1,1,C) BN
tensors), plus an optimizer slot and a Flow-tower variable the converter
must ignore, is written once per module. Both converters must write the
same npz bit for bit with the same report, resolve the same paths, and
raise the same errors; ``convert_variables`` on the same variables (no
TensorFlow) gives the same npz; without TensorFlow ``convert`` raises an
ImportError naming it. The port's I3D on the converted weights agrees
with the JAX package's within 1e-3 of the largest logit (the tolerance of
``tests/test_torch_eval.py``).
"""

import math
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from mocogan_tpu.eval import i3d as ji3d  # noqa: E402
from mocogan_tpu.eval import i3d_convert as jconv  # noqa: E402
from mocogan_tpu_torch import parity_day  # noqa: E402
from mocogan_tpu_torch.eval import i3d as ti3d  # noqa: E402
from mocogan_tpu_torch.eval import i3d_convert as tconv  # noqa: E402

torch.set_num_threads(1)

PREFIX = "RGB/inception_i3d"
EXTRAS = {f"{PREFIX}/Conv3d_1a_7x7/conv_3d/w/Adam": (7, 7, 7, 3, 64),
          "Flow/inception_i3d/Conv3d_1a_7x7/conv_3d/w": (7, 7, 7, 2, 64)}


def _synthetic_vars(seed=0):
    """({checkpoint variable: array} in the public layout with the two
    extras, {contract key: array} it converts to). He-normal kernels and
    non-trivial BN, so the forward pass carries signal to the logits."""
    rng = np.random.default_rng(seed)
    ckpt, truth = {}, {}
    for var, key, want in tconv.variable_map(PREFIX):
        leaf = key.rsplit("/", 1)[1]
        if leaf == "w":
            val = rng.standard_normal(want) * math.sqrt(
                2.0 / math.prod(want[:-1]))
        elif leaf == "var":
            val = np.abs(rng.standard_normal(want)) * 0.1 + 0.9
        else:
            val = rng.standard_normal(want) * 0.05
        val = val.astype(np.float32)
        truth[key] = val
        ckpt[var] = (val.reshape(1, 1, 1, 1, -1)
                     if leaf in ("beta", "mean", "var") else val)
    for var, shape in EXTRAS.items():
        ckpt[var] = np.zeros(shape, np.float32)
    return ckpt, truth


def _write_v1_checkpoint(path_prefix, variables):
    """Write a TF-v1 Saver checkpoint (the public files' format)."""
    with tf.Graph().as_default():
        for name, val in variables.items():
            tf.compat.v1.get_variable(name, initializer=val)
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, path_prefix, write_meta_graph=False)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("i3d_ckpt")
    variables, truth = _synthetic_vars()
    _write_v1_checkpoint(str(d / "model.ckpt"), variables)
    out = d / "converted"
    out.mkdir()
    jreport = jconv.convert_to_npz(str(d / "model.ckpt"),
                                   str(out / "jax.npz"))
    return d, variables, truth, str(out / "jax.npz"), jreport


def _npz(path):
    with np.load(path) as f:
        return dict(f)


def _assert_npz_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_convert_matches_jax(ckpt, tmp_path):
    d, _, truth, jax_npz, jreport = ckpt
    out = str(tmp_path / "port.npz")
    report = tconv.convert_to_npz(str(d / "model.ckpt"), out)
    assert report == jreport
    assert set(EXTRAS) <= set(report["unused"])
    got = _npz(out)
    _assert_npz_equal(got, _npz(jax_npz))
    _assert_npz_equal(got, truth)
    assert set(ti3d.load_npz(out)) == set(ti3d.expected_shapes())


def test_paths_resolve_as_in_jax(ckpt, tmp_path):
    """A directory (through the 'checkpoint' state file) and an .index
    path resolve to the prefix; the CLI converts from the directory."""
    d, _, _, jax_npz, _ = ckpt
    for path in (str(d), str(d / "model.ckpt.index"), str(d / "model.ckpt")):
        assert tconv.resolve_ckpt_prefix(path) == \
            jconv.resolve_ckpt_prefix(path) == str(d / "model.ckpt")
    out = str(tmp_path / "cli.npz")
    report = tconv.main(["--ckpt", str(d), "--out", out])
    assert len(report["converted"]) == len(ti3d.expected_shapes())
    _assert_npz_equal(_npz(out), _npz(jax_npz))


def test_prefix_detection_and_errors_match_jax(ckpt, tmp_path):
    d, variables, _, _, _ = ckpt
    names = tf.train.load_checkpoint(
        str(d / "model.ckpt")).get_variable_to_shape_map()
    assert tconv.detect_prefix(names) == jconv.detect_prefix(names) == PREFIX
    for mod in (jconv, tconv):
        with pytest.raises(ValueError, match="not a kinetics-i3d"):
            mod.detect_prefix(["foo/bar"])
        with pytest.raises(ValueError, match="ambiguous"):
            mod.detect_prefix(["A/Conv3d_1a_7x7/conv_3d/w",
                               "B/Conv3d_1a_7x7/conv_3d/w"])

    first = f"{PREFIX}/Conv3d_1a_7x7/conv_3d/w"
    partial = {first: variables[first]}
    _write_v1_checkpoint(str(tmp_path / "part.ckpt"), partial)
    bad = {first: np.zeros((7, 7, 7, 3, 32), np.float32)}
    _write_v1_checkpoint(str(tmp_path / "bad.ckpt"), bad)
    for name, match in (("part.ckpt", "missing"),
                        ("bad.ckpt", "does not match contract")):
        msgs = []
        for mod in (jconv, tconv):
            with pytest.raises(ValueError, match=match) as e:
                mod.convert(str(tmp_path / name))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        with pytest.raises(ValueError, match=match):
            tconv.convert_variables(partial if name == "part.ckpt" else bad)


def test_convert_variables_without_tensorflow(ckpt, tmp_path, monkeypatch):
    """The read-free part gives the same npz from the variables dict; with
    TensorFlow missing, ``convert`` raises an ImportError naming it and
    falls back to nothing."""
    d, variables, _, jax_npz, jreport = ckpt
    weights, report = tconv.convert_variables(variables)
    assert report == jreport
    out = str(tmp_path / "vars.npz")
    tconv.save_npz(weights, out)
    _assert_npz_equal(_npz(out), _npz(jax_npz))

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        tconv.convert(str(d / "model.ckpt"))
    with pytest.raises(ImportError, match="TensorFlow"):
        tconv.convert_to_npz(str(d), str(tmp_path / "never.npz"))
    assert not (tmp_path / "never.npz").exists()


def test_converted_i3d_matches_jax(ckpt):
    """Logits of the port's I3D on the converted npz against the JAX
    package's I3D on the same file and clip."""
    _, _, _, jax_npz, _ = ckpt
    v = np.random.default_rng(1).uniform(
        -1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    params = ji3d.load_npz(jax_npz)
    want = np.asarray(jax.jit(lambda p, x: ji3d.apply(p, x,
                                                      features="logits"))(
        jax.tree.map(jax.numpy.asarray, params), jax.numpy.asarray(v)))
    ex = ti3d.I3DExtractor(jax_npz, features="logits", resize_to=None,
                           device="cpu")
    got = ex(torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (1, 400)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(want - want.mean()).max() > 1e-2 * scale  # not constant
    assert np.abs(got - want).max() <= 1e-3 * scale


def test_parity_day_converts_the_i3d_checkpoint(ckpt, tmp_path):
    """parity_day --i3d-ckpt alone: the checkpoint converted under --out,
    equal to the JAX converter's npz."""
    d, _, _, jax_npz, _ = ckpt
    out = tmp_path / "pd"
    summary = parity_day.main(["--i3d-ckpt", str(d), "--out", str(out),
                               "--device", "cpu"])
    assert summary["stages"] == {"i3d_convert":
                                 str(out / "i3d_converted.npz")}
    assert set(summary["seconds"]) == {"i3d_convert"}
    _assert_npz_equal(_npz(str(out / "i3d_converted.npz")), _npz(jax_npz))
