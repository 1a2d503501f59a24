"""The extra grams' host self time per evaluation, in ms: the span
``oak.extra`` (``ops/oak_gram.py::_prep``: the binary and categorical
dims' grams, gathered from their tables, and their stack), read from the
program's record of the traced window (``benchmark/spans.py``). Silent
where the record holds no such span: a program without it, or a model with
no discrete dim. Layer: kernels."""

from benchmark import spans

SPAN = "oak.extra"


def read(run):
    got = spans.record(run)
    if got is None or not any(s.name == SPAN for s in got[0].spans):
        return None
    return spans.self_ms(run, [SPAN])
