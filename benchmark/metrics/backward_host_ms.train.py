"""The evaluation's own host self time per evaluation, in ms: the span
``oak.eval`` (``optim/fit.py``'s ``LaneLoss`` and ``value_and_grad``) less
the spans inside it on its thread and its backward's spans on autograd's
device thread: autograd's backward dispatch and vmap's wrapping. Read from
the program's record of the traced window (``benchmark/spans.py``). Layer:
entry and optimizer."""

from benchmark import spans


def read(run):
    return spans.self_ms(run, ["oak.eval"])
