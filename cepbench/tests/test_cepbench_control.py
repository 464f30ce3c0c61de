"""The control (the reference in bfloat16, in the program's place) comes
out as not correct at a size a test run holds; on the card it runs at
each cell's own size (``cepbench/control.py``)."""

import pytest

from _small import small_cell
from cepbench import control


@pytest.mark.parametrize("name", ["fraud16_1m.uniform", "fraud16_1m.hot100k"])
def test_control_is_not_correct(name):
    r = control.readings(small_cell(name), 2**31 + 5, 30, "cpu")
    assert not r["correct"], r
    assert r["checks"]["mismatched_rows"] > 0
    assert r["checks"]["rows_compared"] > 0
