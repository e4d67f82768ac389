"""A pytest module that tests/test_torch_lockgraph.py runs in a
subprocess with the port's lock-order plugin loaded:

    python -m pytest -p kafka_ps_tpu_torch.analysis.pytest_plugin \\
        --noconftest tests/torch_lockgraph_runs.py -k consistent

`-k consistent` takes two locks in one order from two threads (the
session ends 0 with the "no ordering cycles" line); `-k inverted` takes
them in both orders, one thread after the other (the session ends 7 and
prints the cycle).  Named without `test_` so that the suite's own run
never collects it.  Imports no JAX."""

import threading

from kafka_ps_tpu_torch.analysis.lockgraph import OrderedLock


def _run_threads(*fns):
    ts = [threading.Thread(target=fn) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()


def _nested(outer, inner):
    def take():
        with outer:
            with inner:
                pass
    return take


def test_consistent_order():
    a, b = OrderedLock("helper.A"), OrderedLock("helper.B")
    _run_threads(_nested(a, b), _nested(a, b))


def test_inverted_order():
    a, b = OrderedLock("helper.A"), OrderedLock("helper.B")
    _run_threads(_nested(a, b))
    _run_threads(_nested(b, a))
