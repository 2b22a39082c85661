"""The port's subpackage namespaces and the reference names and
parameters the port keeps: every name a JAX ``__init__`` exports and the
port defines resolves from the matching port subpackage, and each added
name or parameter is held to the JAX package on the same input."""

import ast
import importlib
import os
import pickle

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

# JAX names the port does not define yet, with the item that brings them
NOT_PORTED = {}


def _jax_exports(sub):
    path = os.path.join(ROOT, "scintools_tpu", sub, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


CASES = [(sub, name) for sub in ("fit", "io", "ops", "thth", "utils",
                                 "robust", "mcmc", "detect", "serve",
                                 "fleet", "parallel", "sim")
         for name in _jax_exports(sub)
         if name not in NOT_PORTED.get(sub, ())]


@pytest.mark.parametrize("sub,name", CASES,
                         ids=[f"{s}.{n}" for s, n in CASES])
def test_name_resolves(sub, name):
    mod = importlib.import_module(f"scintools_tpu_torch.{sub}")
    assert getattr(mod, name) is not None
    assert name in mod.__all__


@pytest.mark.parametrize("name", ["ACF", "Dynspec", "Simulation",
                                  "Brightness", "run_psrflux_survey",
                                  "run_wavefield_survey", "sort_dyn",
                                  "serve_psrflux_survey"])
def test_top_level_name(name):
    import scintools_tpu as J
    import scintools_tpu_torch as T

    assert getattr(T, name).__name__ == getattr(J, name).__name__


def test_obs_and_parallel_namespaces():
    from scintools_tpu_torch import obs as tobs
    from scintools_tpu_torch import parallel as tpar

    left_out = {"programs"}    # traces jaxprs for the JAX lint pass
    want = [n for n in _jax_exports("obs") if n not in left_out]
    assert [n for n in want if not hasattr(tobs, n)] == []
    for n in ("EpochJournal", "atomic_write_bytes", "atomic_write_json",
              "PrefetchLoader", "AsyncJournalWriter", "DeferredResult",
              "LoadedEpoch", "finalize_result", "SurveyCheckpointer"):
        assert hasattr(tpar, n)


class TestReferenceNames:
    def test_autocorr_direct(self):
        from scintools_tpu.ops.acf import autocorr_direct as j
        from scintools_tpu_torch.ops import autocorr_direct as t

        rng = np.random.default_rng(3)
        arr = rng.normal(size=(6, 5))
        arr[2, 3] = np.nan
        np.testing.assert_array_equal(t(arr), j(arr))
        mask = np.zeros(arr.shape, dtype=bool)
        mask[0, 0] = True
        np.testing.assert_array_equal(t(arr, mask=mask), j(arr, mask=mask))

    def test_parameters_add_many(self):
        from scintools_tpu.fit.parameters import Parameters as J
        from scintools_tpu_torch.fit import Parameters as T

        items = [("tau", 10.0, True, 0, np.inf), ("dnu", 0.5),
                 ("wn", 0.0, False)]
        j, t = J(), T()
        j.add_many(*items)
        t.add_many(*items)
        assert list(t) == list(j)
        for k in j:
            for a in ("value", "vary", "min", "max"):
                assert getattr(t[k], a) == getattr(j[k], a)

    @pytest.mark.parametrize("name,args", [
        ("difference", (np.array([1.0, 4.0, 9.0, 16.0, 25.0]),)),
        ("find_nearest", (np.array([0.1, 0.5, 0.9]), 0.6)),
        ("longest_run_of_zeros", (np.array([1, 0, 0, 2, 0, 0, 0, 1]),)),
        ("centres_to_edges", (np.array([1.0, 2.0, 3.0]),)),
        ("cov_to_corr", (np.array([[4.0, 1.0, 0.0], [1.0, 9.0, 0.0],
                                   [0.0, 0.0, 0.0]]),)),
        ("mjd_to_year", (np.array([51544.5, 60000.0]),)),
        ("acor", (np.sin(np.linspace(0, 20, 200)),)),
        ("slow_FT", (np.random.default_rng(1).normal(size=(8, 5)),
                     np.linspace(1300.0, 1400.0, 5))),
    ])
    def test_misc_helpers(self, name, args):
        from scintools_tpu.utils import misc as jm
        from scintools_tpu_torch.utils import misc as tm

        np.testing.assert_array_equal(getattr(tm, name)(*args),
                                      getattr(jm, name)(*args))

    def test_misc_file_helpers(self, tmp_path):
        from scintools_tpu.utils import misc as jm
        from scintools_tpu_torch.utils import misc as tm

        obj = {"a": np.arange(4), "b": "x"}
        tm.make_pickle(obj, tmp_path / "t.pkl")
        jm.make_pickle(obj, tmp_path / "j.pkl")
        assert (tmp_path / "t.pkl").read_bytes() \
            == (tmp_path / "j.pkl").read_bytes()
        got = tm.load_pickle(tmp_path / "j.pkl")
        np.testing.assert_array_equal(got["a"], obj["a"])
        assert pickle.loads((tmp_path / "t.pkl").read_bytes())["b"] == "x"
        for mod, name in ((tm, "t.txt"), (jm, "j.txt")):
            (tmp_path / name).write_text("alpha beta alpha")
            mod.search_and_replace(tmp_path / name, "alpha", "gamma")
        assert (tmp_path / "t.txt").read_text() \
            == (tmp_path / "j.txt").read_text() == "gamma beta gamma"

    def test_fit_acf2d_tpu_name(self):
        from scintools_tpu_torch.fit import acf2d

        assert acf2d.fit_acf2d_tpu is acf2d.fit_acf2d

    def test_acf_backend(self):
        from scintools_tpu.sim.acf_model import ACF as J
        from scintools_tpu_torch import ACF as T

        t = T(nt=9, nf=9, backend=None, device=CPU)
        j = J(nt=9, nf=9, backend=None)
        np.testing.assert_allclose(np.asarray(t.acf), np.asarray(j.acf),
                                   rtol=1e-5, atol=1e-6)
        with pytest.raises(NotImplementedError):
            T(nt=9, nf=9, backend="jax", device=CPU)

    def test_unit_checks_desired(self):
        from scintools_tpu.thth.core import unit_checks as j
        from scintools_tpu_torch.thth import unit_checks as t

        class Q:
            value = 2.0

            def to_value(self, unit):
                return {"us": 2.0e6, "s": 2.0}[unit]

        assert t(Q(), "x", desired="us") == j(Q(), "x", desired="us")
        assert t(Q(), "x") == j(Q(), "x") == 2.0
        assert t(Q(), desired="km") == j(Q(), desired="km") == 2.0
        assert t(3.5) == j(3.5)

    @pytest.mark.parametrize("variant", ["rfft", "fft2"])
    def test_fft2_full_s(self, variant):
        from scintools_tpu.ops.xfft import fft2_full as j
        from scintools_tpu_torch.ops.xfft import fft2_full as t

        x = np.random.default_rng(2).normal(size=(2, 5, 6))
        got = t(torch.as_tensor(x), variant=variant, s=(8, 9)).numpy()
        np.testing.assert_allclose(got, j(x, variant=variant, s=(8, 9)),
                                   rtol=1e-10, atol=1e-10)

    def test_chunk_conjugate_spectrum_batch_shift(self):
        from scintools_tpu.ops.sspec import (
            chunk_conjugate_spectrum_batch as j)
        from scintools_tpu_torch.ops.sspec import (
            chunk_conjugate_spectrum_batch as t)

        x = np.random.default_rng(4).normal(size=(3, 8, 6))
        got = t(torch.as_tensor(x), npad=1, shift=False).numpy()
        want = j(x, npad=1, shift=False)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)
        with pytest.raises(ValueError):
            t(torch.as_tensor(x), npad=1, shift=False,
              tau_keep=np.ones(16, dtype=bool))

    def test_compat_aliases(self):
        from scintools_tpu import compat as J
        from scintools_tpu_torch import compat as T

        assert set(T.__all__) == set(J.__all__)
        for name in T.__all__:
            assert callable(getattr(T, name))
        arr = np.random.default_rng(5).normal(size=(4, 4))
        np.testing.assert_array_equal(T.autocorr(arr), J.autocorr(arr))

    def test_archive_stub(self):
        from scintools_tpu.utils import archive as J
        from scintools_tpu_torch.utils import archive as T

        assert T.archive_tools_available() == J.archive_tools_available()
        if not T.archive_tools_available():
            with pytest.raises(ImportError):
                T.clean_archive("x.ar")
