"""Device-to-host reads per evaluation: the program's counter
``host_reads`` (each read on the fit's path that waits for the device,
counted at its site in ``optim/fit.py`` and ``optim/multistart.py``), read
from its record of the traced window (``benchmark/spans.py``); 0 where the
window's steps read nothing. Layer: entry and optimizer."""

from benchmark import spans


def read(run):
    return spans.per_eval(run, "host_reads")
