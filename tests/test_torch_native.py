"""The port's bindings of the native library's parsers
(`robocheck_tpu_torch.runtime.native`: ``parse_conf``, ``write_conf``,
``parse_obj``) against the port's Python loaders (`io.conf`, `io.obj`), as
tests/test_native.py holds the JAX package's. They skip where the native
library is not built (``make -C native``, or ``ROBOCHECK_NATIVE_LIB``
pointing at a build)."""
import numpy as np
import pytest

from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.conf import read_conf_file
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.runtime import native


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native library not built (make -C native)")


def test_conf_parser_matches_python(lib):
    path = assets.dataset_path("hard10k")
    confs, valid = native.parse_conf(str(path))
    ds = read_conf_file(path)
    np.testing.assert_array_equal(confs, ds.confs)
    np.testing.assert_array_equal(valid, ds.valid)


def test_obj_parser_matches_python(lib):
    path = assets.alpha_robot_path()
    verts, tris = native.parse_obj(str(path))
    mesh = load_obj(path)
    np.testing.assert_array_equal(verts, mesh.vertices)
    np.testing.assert_array_equal(tris, mesh.triangles)


def test_conf_writer_roundtrip(lib, tmp_path, rng):
    confs = rng.normal(size=(32, 6)).astype(np.float32)
    valid = rng.random(32) > 0.4
    p = tmp_path / "n.conf"
    native.write_conf(str(p), confs, valid.astype(np.int8))
    back_c, back_v = native.parse_conf(str(p))
    np.testing.assert_allclose(back_c, confs, rtol=1e-5)
    np.testing.assert_array_equal(back_v, valid)
    assert p.read_text().startswith(f"There are {valid.sum()} valid")
    ds = read_conf_file(p)
    np.testing.assert_array_equal(ds.confs, back_c)
    np.testing.assert_array_equal(ds.valid, valid)


def test_parsers_raise_on_a_missing_file(lib, tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_conf(str(tmp_path / "missing.conf"))
    with pytest.raises(FileNotFoundError):
        native.parse_obj(str(tmp_path / "missing.obj"))
