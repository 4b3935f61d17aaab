"""The backend scope API on the port's names (``cuda``, ``torch``): the
reference's ``tests/test_fft_api.py`` scoping cases, and the port's rule
that a backend never runs on a device it was not registered for."""

import warnings

import numpy as np
import pytest
import torch

from repro.core import fft as ref_fft
from repro_torch.core import fft as F
from repro_torch.core.faults import PlanError


@pytest.fixture(autouse=True)
def _clean_scope():
    saved = F._GLOBAL_DEFAULT
    try:
        yield
    finally:
        F._GLOBAL_DEFAULT = saved
        assert F._scope_stack() == []


def test_registry_names():
    assert F.available_backends() == ("cuda", "torch")
    assert F.get_backend("torch").device_types == frozenset({"cpu"})
    assert F.get_backend("cuda").device_types == frozenset({"cuda"})


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown FFT backend"):
        F.plan(F.FFTSpec(n=64), device="cpu", backend="nope")
    with pytest.raises(ValueError, match="unknown FFT backend"):
        with F.use_backend("nope"):
            pass  # pragma: no cover
    with pytest.raises(PlanError, match="unknown FFT backend"):
        F.get_backend("xla")
    # The reference's registry refuses its own way, with the same words.
    with pytest.raises(ValueError, match="unknown FFT backend"):
        ref_fft.get_backend("nope")


def test_use_backend_scopes_and_nests():
    base = F.default_backend()
    with F.use_backend("torch"):
        assert F.default_backend() == "torch"
        with F.use_backend("cuda"):
            assert F.default_backend() == "cuda"
        assert F.default_backend() == "torch"
    assert F.default_backend() == base


def test_use_backend_restores_on_exception():
    base = F.default_backend()
    with pytest.raises(RuntimeError):
        with F.use_backend("torch"):
            assert F.default_backend() == "torch"
            raise RuntimeError("boom")
    assert F.default_backend() == base


def test_use_backend_drives_plan_selection():
    x = torch.randn(2, 256, dtype=torch.complex64)
    with F.use_backend("torch"):
        p = F.plan(F.FFTSpec(n=256), device="cpu")
        y = F.fft(x)
    assert p.backend.name == "torch"
    assert p is F.plan(F.FFTSpec(n=256), device="cpu", backend="torch")
    want = np.fft.fft(x.numpy().astype(np.complex128))
    assert np.abs(y.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    # Every wrapper takes backend=.
    real = torch.randn(2, 8, 16)
    assert F.irfft(F.rfft(real, backend="torch"), 16, backend="torch").shape == real.shape
    assert F.irfft2(F.rfft2(real, backend="torch"), 16, 8, backend="torch").shape == real.shape
    assert F.ifft2(F.fft2(real.to(torch.complex64), backend="torch"), backend="torch").shape == real.shape
    assert F.ifft(F.fft(x, backend="torch"), backend="torch").shape == x.shape


def test_set_default_backend_deprecated():
    with pytest.warns(DeprecationWarning):
        F.set_default_backend("torch")
    assert F.default_backend() == "torch"
    with pytest.raises(PlanError, match="unknown FFT backend"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            F.set_default_backend("nope")


def test_environment_names_the_default(monkeypatch):
    monkeypatch.setattr(F, "_GLOBAL_DEFAULT", "torch")
    assert F.default_backend() == "torch"
    with F.use_backend("cuda"):
        assert F.default_backend() == "cuda"


def test_backend_refused_on_the_wrong_device():
    """No fallback: ``cuda`` on a CPU tensor raises, and so does ``torch``
    on the card (checked without one: the device comes first)."""
    x = torch.randn(2, 64, dtype=torch.complex64)
    with pytest.raises(PlanError, match="runs on \\['cuda'\\]"):
        F.plan(F.FFTSpec(n=64), device="cpu", backend="cuda")
    with pytest.raises(PlanError, match="runs on \\['cuda'\\]"):
        F.fft(x, backend="cuda")
    with F.use_backend("cuda"), pytest.raises(PlanError, match="runs on \\['cuda'\\]"):
        F.fft(x)
    with pytest.raises(PlanError, match="runs on \\['cpu'\\]"):
        F._backend_for(torch.device("cuda", 0), "torch")
    if not torch.cuda.is_available():
        with F.use_backend("torch"), pytest.raises(PlanError, match="no CUDA device"):
            F.plan(F.FFTSpec(n=64))
