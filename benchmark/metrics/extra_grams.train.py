"""Extra grams handed to K1 per evaluation: the program's counter
``gram.extra`` (E grams a lane of each launch, counted in
``ops/oak_gram.py``), read from its record of the traced window
(``benchmark/spans.py``). Silent where the record holds no such counter: a
program without it, or a model with no discrete dim. Layer: kernels."""

from benchmark import spans

COUNTER = "gram.extra"


def read(run):
    got = spans.record(run)
    if got is None or COUNTER not in got[0].counters:
        return None
    return spans.per_eval(run, COUNTER)
