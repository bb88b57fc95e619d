"""The port's analysis-suite example (``examples/analysis_suite_torch.py``)
on the CPU against the reference example (``examples/analysis_suite.py``),
run in this process: kNN indices exact and distances within ``rtol=2e-6``,
the MST's edges (as a set) and rounds exact and its total weight within
``rtol=1e-5``, the correlation exact, the MLS values within their Gram
matrices' condition number times float32's unit roundoff, and the ray
hits and ``t`` bit for bit (see the tests of each module for why)."""
import importlib.util
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_interpolate import _gram_condition  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "analysis_suite_torch", ROOT / "examples" / "analysis_suite_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analysis_suite_example_matches_reference_example(capsys):
    ex = _example()
    ex.main(["--device", "cpu"])
    assert "OK:" in capsys.readouterr().out
    got = ex.run("cpu")
    want = runpy.run_path(str(ROOT / "examples" / "analysis_suite.py"))
    capsys.readouterr()

    np.testing.assert_array_equal(got["knn"].indices.numpy(),
                                  np.asarray(want["nn"].indices))
    np.testing.assert_allclose(got["knn"].distances.numpy(),
                               np.asarray(want["nn"].distances), rtol=2e-6)

    tree, jtree = got["emst"], want["tree"]
    assert int(tree.rounds) == int(jtree.rounds)
    assert ({tuple(e) for e in np.sort(tree.edges.numpy(), 1).tolist()}
            == {tuple(e) for e in np.sort(np.asarray(jtree.edges), 1).tolist()})
    np.testing.assert_allclose(float(tree.total_weight),
                               float(jtree.total_weight), rtol=1e-5)

    np.testing.assert_array_equal(got["xi"], want["xi"])

    tol = 1e-6 + _gram_condition(got["pts"], got["targets"], 10) * 2.0 ** -24
    assert (np.abs(got["mls"].numpy() - np.asarray(want["interp"])) <= tol).all()

    np.testing.assert_array_equal(got["rays"].index.numpy(),
                                  np.asarray(want["hits"].index))
    np.testing.assert_array_equal(got["rays"].t.numpy().view(np.int32),
                                  np.asarray(want["hits"].t).view(np.int32))
