"""Multi-controller runs of the port at 2 gloo ranks against the
reference package (the failure matrix of tests/torch_multihost_matrix.py,
run once in a module fixture; each check is a test of its own)."""
import pytest

from torch_multihost_matrix import run_matrix
from torch_multihost_checks import *  # noqa: F401,F403  the checks

PROCS = 2


@pytest.fixture(scope="module")
def mh(tmp_path_factory):
    return run_matrix(tmp_path_factory.mktemp("multihost"), PROCS)
