"""msa_tpu_torch's preprocessing copies against the JAX package's.

The nine cases of ``tests/test_preprocessing.py`` on its in-memory fakes
(no mmsdk, no dataset): each runs the port's function and JAX's on the same
input, and their outputs (and what they print) must be equal; then the
port's ``cli.preprocess`` against JAX's on synthetic UR_FUNNY SDK pickles,
and the mmsdk gate of the CMU path.
"""

import importlib.util
import pickle

import numpy as np
import pytest

from msa_tpu.cli import preprocess as jax_cli
from msa_tpu.data.preprocessing import cmu as jax_cmu
from msa_tpu.data.preprocessing import ur_funny as jax_ur
from msa_tpu_torch.cli import preprocess as port_cli
from msa_tpu_torch.data.preprocessing import cmu, ur_funny
from test_preprocessing import (
    FIELDS, _dataset, _segment, _words, _write_ur_funny_sdk)


def assert_same(a, b):
    """Nested tuples / lists / dicts of arrays and scalars, equal by value
    and dtype (NaN equal to NaN)."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind in "fc":
            np.testing.assert_array_equal(a, b)
        else:
            assert a.tolist() == b.tolist()
    else:
        assert a == b


def both(capsys, fn_port, fn_jax, *args, **kw):
    """Run both, compare results and printed output; return the port's."""
    got = fn_port(*args, **kw)
    said = capsys.readouterr().out
    want = fn_jax(*args, **kw)
    assert capsys.readouterr().out == said
    assert_same(got, want)
    return got, said


def test_fold_routing_and_format(capsys):
    segs = {
        "vidA[0]": _segment(_words("hello", "world"), seed=1),
        "vidA[1]": _segment(_words("more", "text"), seed=2),
        "vidB[0]": _segment(_words("val", "clip"), seed=3),
        "vidC[0]": _segment(_words("test", "clip"), seed=4),
        "vidZ[0]": _segment(_words("lost"), seed=5),
    }
    (train, val, test), said = both(
        capsys, cmu.prepare_segments, jax_cmu.prepare_segments,
        _dataset(segs), FIELDS, ["vidA"], ["vidB"], ["vidC"])
    assert [e[2] for e in train] == ["vidA[0]", "vidA[1]"]
    assert [e[2] for e in val + test] == ["vidB[0]", "vidC[0]"]
    assert "0 datapoints have been dropped" in said


def test_pause_tokens_stripped_rowwise(capsys):
    seg = _segment(_words("sp", "keep", "sp", "also"), seed=7)
    (train, _, _), _ = both(capsys, cmu.prepare_segments,
                            jax_cmu.prepare_segments,
                            _dataset({"v[0]": seg}), FIELDS, ["v"], [], [])
    assert list(train[0][0][0]) == ["keep", "also"]


def test_drop_reasons_counted(capsys):
    bad_shape = _segment(_words("a", "b"), seed=8)
    bad_shape["vis"]["features"] = bad_shape["vis"]["features"][:1]
    missing = _segment(_words("a"), seed=9)
    del missing["spc"]
    segs = {"no_brackets": _segment(_words("x"), seed=11),
            "v[0]": bad_shape, "v[1]": missing,
            "v[2]": _segment(_words("sp", "sp"), seed=10),
            "v[3]": _segment(_words("good"), seed=12)}
    (train, _, _), said = both(capsys, cmu.prepare_segments,
                               jax_cmu.prepare_segments, _dataset(segs),
                               FIELDS, ["v"], [], [])
    assert [e[2] for e in train] == ["v[3]"]
    assert "4 datapoints have been dropped" in said


def test_nan_scrubbed_from_label_and_features(capsys):
    seg = _segment(_words("a", "b"), seed=13)
    seg["lbl"]["features"] = np.array([[np.nan]])
    seg["vis"]["features"][0, 0] = np.nan
    (train, _, _), _ = both(capsys, cmu.prepare_segments,
                            jax_cmu.prepare_segments,
                            _dataset({"v[0]": seg}), FIELDS, ["v"], [], [])
    assert train[0][1][0, 0] == 0.0 and np.isfinite(train[0][0][1]).all()


@pytest.mark.parametrize("x", [
    np.random.default_rng(0).standard_normal((6, 4)), np.ones((5, 2)),
    np.array([[1e-12], [0.0], [0.0], [0.0]])])
@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_znorm_formula_and_eps_deviation(x, eps):
    with np.errstate(invalid="ignore"):
        assert_same(cmu.znorm(x, eps), jax_cmu.znorm(x, eps))


def test_avg_collapse():
    f = np.array([[1.0, 2.0], [3.0, 4.0]])
    assert_same(cmu.avg_collapse(None, f), jax_cmu.avg_collapse(None, f))
    assert cmu.avg_collapse(None, "unaveragable") == "unaveragable"


def test_save_pickle_roundtrip(tmp_path, capsys):
    for mod, name in ((cmu, "port.pkl"), (jax_cmu, "jax.pkl")):
        mod.save_pickle([1], [2], [3, 4], str(tmp_path / name))
    assert capsys.readouterr().out == "Save Complete!\n" * 2
    assert (tmp_path / "port.pkl").read_bytes() == \
        (tmp_path / "jax.pkl").read_bytes()


def test_parse_ur_funny(tmp_path, capsys):
    _write_ur_funny_sdk(tmp_path, ["k0", "k1", "k2", "k3", "k4"],
                        drop_mismatch_key="k1")
    (train, dev, test), said = both(capsys, ur_funny.parse_ur_funny,
                                    jax_ur.parse_ur_funny, str(tmp_path))
    assert [e[2] for e in train + dev + test] == ["k0", "k2", "k3", "k4"]
    assert "1 datapoints have been dropped" in said


def test_ur_funny_run_writes_pickle(tmp_path, capsys):
    _write_ur_funny_sdk(tmp_path, ["k0", "k1", "k2", "k3"])
    ur_funny.run(str(tmp_path), str(tmp_path / "port.pkl"))
    jax_ur.run(str(tmp_path), str(tmp_path / "jax.pkl"))
    got = pickle.load(open(tmp_path / "port.pkl", "rb"))
    assert_same(got, pickle.load(open(tmp_path / "jax.pkl", "rb")))
    assert [len(got[k]) for k in ("train", "val", "test")] == [2, 1, 1]


def test_preprocess_cli_matches_jax(tmp_path, capsys):
    """``python -m msa_tpu_torch.cli.preprocess --dataset ur_funny`` writes
    JAX's CLI's pickle; the CMU path raises JAX's ImportError without
    mmsdk (the gate, before any download; with mmsdk installed the path
    would download, so that half runs only where it is absent)."""
    _write_ur_funny_sdk(tmp_path, ["k0", "k1", "k2", "k3", "k4"])
    for cli, name in ((port_cli, "port.pkl"), (jax_cli, "jax.pkl")):
        cli.main(["--dataset", "ur_funny", "--data_path", str(tmp_path),
                  "--out", str(tmp_path / name), "--eps", "0.001"])
    assert_same(pickle.load(open(tmp_path / "port.pkl", "rb")),
                pickle.load(open(tmp_path / "jax.pkl", "rb")))
    if importlib.util.find_spec("mmsdk") is not None:
        return  # with mmsdk the CMU path would download the dataset
    for cli in (port_cli, jax_cli):
        with pytest.raises(ImportError, match="CMU-MultimodalSDK"):
            cli.main(["--dataset", "cmu_mosi", "--data_path",
                      str(tmp_path / "sdk")])
