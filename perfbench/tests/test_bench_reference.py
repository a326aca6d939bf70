"""The plain reference against the port's float64 oracle and its plain
route on the CPU, and the TF32 control against the limits.  (The tests
may import the port; the reference may not.)"""

import numpy as np
import torch

from mfcc_tpu_torch import oracle
from mfcc_tpu_torch.config import FeatureConfig
from mfcc_tpu_torch.models.logmel import log_mel_batch
from mfcc_tpu_torch.models.mfcc import mfcc_batch
from perfbench import check, corpus, harness
from perfbench.reference import features as ref
from perfbench.tests.hostdev import tiny


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def _batch(seed=11):
    t = tiny(harness.load_json(harness.HERE / "traffic" / "libri_sorted.json"),
             batch=3, utterances=3)
    return corpus.build(t, seed, "cpu").batches[0]


def _per_utterance_oracle(b, cfg, fn):
    return [fn(b.x[i, :n].double().numpy() / 32768.0, cfg)
            for i, n in enumerate(b.lengths_host)]


def test_reference_equals_the_float64_oracle():
    b = _batch()
    for name, fn in (("htk-mfcc13-16k", oracle.mfcc),
                     ("kaldi-fbank80-deltas-16k", oracle.log_mel)):
        c = _config(name)
        cfg = FeatureConfig(**c["features"])
        feat, flens, mask = ref.features(b.x, b.lengths_host, c["features"],
                                         c["output"] == "cepstra")
        assert feat.dtype == torch.float64
        for i, want in enumerate(_per_utterance_oracle(b, cfg, fn)):
            T = want.shape[0]
            assert int(flens[i]) == T and int(mask[i].sum()) == T
            np.testing.assert_allclose(feat[i, :T].numpy(), want,
                                       rtol=0, atol=1e-9)
            assert torch.count_nonzero(feat[i, T:]) == 0


def test_reference_agrees_with_the_ports_plain_route():
    b = _batch(12)
    for name, entry, tol in (("htk-mfcc13-16k", mfcc_batch, 1e-4),
                             ("kaldi-fbank80-deltas-16k", log_mel_batch, 2e-3)):
        c = _config(name)
        cfg = FeatureConfig(**c["features"])
        got = entry(b.x, b.lengths, cfg, backend="torch")
        numbers, checked, failed = check.compare(
            dict(c, limits=dict(c["limits"], static_err=tol, delta_err=tol,
                                delta2_err=tol)), [b], [got])
        assert check.correct(numbers), numbers
        assert checked == 3 and failed == 0


def test_tf32_rounding():
    x = torch.randn(10000) * 1e3
    r = ref.round_tf32(x)
    bits = r.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.equal(ref.round_tf32(r), r)


def test_the_control_fails_the_limits():
    b = _batch(13)
    for name in ("htk-mfcc13-16k", "kaldi-fbank80-deltas-16k"):
        c = _config(name)
        numbers, _, failed = check.compare(c, [b], [None], "tf32")
        assert not check.correct(numbers)
        assert numbers["static_err"][0] > 10 * numbers["static_err"][1]
        assert failed == 3
