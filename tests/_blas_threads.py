"""numpy's BLAS on two threads for the multi-device test modules, which
import :func:`_blas_two_threads` (autouse): the suite runs six workers
on the host's cores, and OpenBLAS's default of one spinning thread per
core stalls every worker's small products (the reference's NequIP
intertwiners took 25 s instead of 0.5 s under the full suite)."""
import pytest
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def _blas_two_threads():
    with threadpool_limits(2, user_api="blas"):
        yield
