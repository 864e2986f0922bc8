"""The port's registry sweep against the reference's, part 1 of 3 (the
harness and its rules: ``test_torch_op_sweep.py``)."""

import pytest

from test_torch_op_sweep import ALL, _cpu, run_case  # noqa: F401


@pytest.mark.parametrize("op_name", ALL[1::3])
def test_op_sweep_port(op_name):
    run_case(op_name)
