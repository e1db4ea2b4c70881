# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real (1-device) CPU topology; only launch/dryrun.py forces 512 devices.
import numpy as np
import pytest

# ---------------------------------------------------------------------------
# hypothesis compat shim: the property tests import `hypothesis`
# unconditionally. When it isn't installed, degrade `@given` to a fixed
# deterministic sweep of examples (seeded per-test) instead of failing the
# whole collection with ModuleNotFoundError.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import functools
    import inspect
    import sys
    import types
    import zlib

    _MAX_EXAMPLES = 6  # fixed sweep size when degrading @given

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def _sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda rng: items[int(rng.integers(0, len(items)))])

    def _booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_max_examples", None) or getattr(
                    fn, "_max_examples", None
                ) or _MAX_EXAMPLES
                n = min(n, _MAX_EXAMPLES)
                seed0 = zlib.crc32(fn.__qualname__.encode("utf-8"))
                for ex in range(n):
                    rng = np.random.default_rng((seed0 + ex) % 2**32)
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    fn(*args, **drawn, **kwargs)

            # pytest introspects the signature to decide which fixtures to
            # inject; strategy-provided params must not look like fixtures
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(
                parameters=[
                    p for name, p in sig.parameters.items()
                    if name not in strategies
                ]
            )
            wrapper.__dict__.pop("__wrapped__", None)
            return wrapper

        return deco

    def _settings(**kw):
        def deco(fn):
            fn._max_examples = kw.get("max_examples")
            return fn

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans
    _st.floats = _floats

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_repro_stub__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (CUDA kernels of repro_torch); "
        "skipped without one",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolated_obs():
    """Observability hygiene: every test starts with the no-op tracer and
    a fresh metrics registry, and leaves none of its spans/series behind
    for the next test (mirrors ``_isolated_calibration``)."""
    from repro import obs

    prev_tracer = obs.set_tracer(None)
    prev_registry = obs.set_registry(None)
    yield
    obs.set_tracer(prev_tracer)
    obs.set_registry(prev_registry)


@pytest.fixture(autouse=True)
def _isolated_calibration():
    """Cost-model calibration hygiene: the module-level default store is
    emptied around every test, so one test's recorded ms/image can never
    flip another test's ``plan(model="auto")`` decision. (Index-scoped
    stores are per-instance and need no guard.)"""
    from repro.core.engine import costmodel

    costmodel.reset_default_calibration()
    yield
    costmodel.reset_default_calibration()
