"""Device ms a batch of the operations launched inside the program's
``feat.cast`` span (the int16 cast), innermost, in the program spans'
traced pass (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.span_ms(run, "feat.cast")
