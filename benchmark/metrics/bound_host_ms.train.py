"""The bound's host self time per evaluation, in ms: the span ``oak.bound``
(``training_loss`` of ``models/svgp.py`` and ``models/sgpr.py``, less its
grams and linear algebra: the likelihood's expectations, the KL, the prior
density, SGPR's clamps), read from the program's record of the traced
window (``benchmark/spans.py``). Layer: likelihood and bound."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.bound"])
