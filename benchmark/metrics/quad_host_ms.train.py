"""The Gauss–Hermite quadrature's host self time per evaluation, in ms: the
span ``oak.quad`` (``ops/quadrature.py``, the Bernoulli likelihood's
variational expectations), read from the program's record of the traced
window (``benchmark/spans.py``). Silent where the record holds no such
span: a program without it, or a model without the quadrature. Layer:
likelihood and bound."""

from benchmark import spans

SPAN = "oak.quad"


def read(run):
    got = spans.record(run)
    if got is None or not any(s.name == SPAN for s in got[0].spans):
        return None
    return spans.self_ms(run, [SPAN])
