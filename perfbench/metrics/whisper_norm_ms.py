"""Device ms a batch of the operations launched inside the program's
``feat.whisper_norm`` span (each row's maximum, its floor and the affine
of Whisper's features), innermost, in the program spans' traced pass
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.span_ms(run, "feat.whisper_norm")
