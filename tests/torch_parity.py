"""Shared check of the PyTorch port's parity tests.

`assert_close` asserts the maximum absolute difference and adds it to the
test's report as a user property, so the JUnit XML of a run holds every
measured error beside its tolerance:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels.py \
        tests/test_torch_imagebind.py tests/test_torch_ingest.py --junitxml=parity.xml
"""

import numpy as np


def assert_close(request, got, want, tol: float, what: str = "max_abs_err", scale: float = 1.0) -> float:
    """max |got - want| / scale <= tol; records `what` = "<err> <= <tol>"."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) / scale
    request.node.user_properties.append((what, f"{err!r} <= {tol!r}"))
    assert err <= tol, f"{what}: {err!r} > {tol!r}"
    return err
