"""The port's restore-and-replay held against the JAX package's.

``tests/test_crash_recovery.py`` replayed through both packages by
``test_torch_persistence.py``'s twin runs: a simulated crash on the
``ingest`` fault site, a fresh runtime of the same manager restoring the
last revision and replaying the input journal, and the callback sequence
across the crash equal to an uninterrupted run's, in each package and
between them — on the device query path (``device_single``) and the
dense general step (``dense_nfa``); async recovery; journal overflow,
spilled to the store and replayed, or refused with a WARNING on a store
without segments; a raw-bytes restore forgetting the ledger; and an
``@sink`` publishing each event once across the crash (the journal's
output ledger keyed by the sink).
"""

from __future__ import annotations

import pytest

from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import INNER_IMPORTS, cases, check_twin

pytestmark = pytest.mark.faults

CASES = cases("test_crash_recovery", {})
# the sink case imports the broker inside its body
INNER = INNER_IMPORTS + ("siddhi_tpu.transport.broker",)


def test_the_corpus_was_read():
    assert len(CASES) == 11


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_crash_recovery_corpus_as_the_reference(corpus, cname, mname, k,
                                                tmp_path, request):
    jax, port = check_twin(corpus, cname, mname, k, tmp_path, request,
                           inner=INNER)
    # the sink case holds its broker's messages itself
    assert any(port.got.values()) or cname == "TestSinkExactlyOnce"
