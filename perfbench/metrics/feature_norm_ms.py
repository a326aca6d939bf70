"""Device ms a batch of the operations launched inside the program's
``feat.feature_norm`` span (NeMo's per-feature normalization: each band's
masked mean and standard deviation over a row's valid frames, the affine
and the zeros past them), innermost, in the program spans' traced pass
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.span_ms(run, "feat.feature_norm")
