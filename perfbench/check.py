"""The comparison that decides ``correct``.

The window keeps, on the device, the outputs that the timed calls
themselves produced for a few batches drawn from the seed
(``corpus.check_ordinals``).  Once the window has closed, the reference
(``reference/<module>.py``, named by the configuration) computes the same
batches from the same int16 inputs, and each number below is compared with
the configuration's limit for it:

- ``static_err``, ``delta_err``, ``delta2_err``: the largest absolute
  difference on valid frames, in the static columns (cepstra or log-mel)
  and, with deltas, in the delta and delta-delta columns;
- ``frames_off``: utterances whose frame count differs;
- ``mask_off``: entries of the frame mask that differ;
- ``pad_nonzero``: feature values on padded frames that are not zero;
- ``nonfinite``: feature values on valid frames that are NaN or infinite.

The errors are taken over finite values; a non-finite one counts in
``nonfinite``.  A run is correct when every number is at most its limit.
"""

from __future__ import annotations

import importlib

import torch

GROUPS = ("static_err", "delta_err", "delta2_err")
COUNTS = ("frames_off", "mask_off", "pad_nonzero", "nonfinite")


def reference(config: dict):
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def reference_outputs(config: dict, batch, precision: str = "float64"):
    """The reference's (feat, frame counts, mask) of one batch."""
    return reference(config).features(
        batch.x, batch.lengths_host, config["features"],
        config["output"] == "cepstra", precision)


def _one(prog, ref, width: int, groups: int):
    """Per-utterance numbers of one batch: {name: (B,) float64 tensor}."""
    feat, flens, mask = prog
    rfeat, rflens, rmask = ref
    feat = feat.to(torch.float64)
    out = {"frames_off": (flens.to(torch.int64) != rflens).to(torch.float64),
           "mask_off": (mask != rmask).sum(1).to(torch.float64),
           "pad_nonzero": ((feat != 0) & ~rmask[..., None]).sum((1, 2))
           .to(torch.float64)}
    finite = torch.isfinite(feat)
    out["nonfinite"] = (~finite & rmask[..., None]).sum((1, 2)).to(torch.float64)
    diff = torch.where(finite & rmask[..., None], (feat - rfeat).abs(), 0.0)
    for g in range(groups):
        out[GROUPS[g]] = diff[..., g * width:(g + 1) * width].amax((1, 2))
    return out


def compare(config: dict, batches: list, kept: list,
            precision: str = "float64") -> tuple:
    """kept[i]: the program's outputs of batches[i] (or None: the control,
    the reference at ``precision`` in the program's place) ->
    ({name: (value, limit)}, utterances checked, utterances failed)."""
    f = config["features"]
    width = f["n_mfcc"] if config["output"] == "cepstra" else f["n_mels"]
    groups = 3 if f["deltas"] else 1
    limits = config["limits"]
    names = GROUPS[:groups] + COUNTS
    worst = dict.fromkeys(names, 0.0)
    checked = failed = 0
    for batch, prog in zip(batches, kept):
        ref = reference_outputs(config, batch)
        if prog is None:
            prog = reference_outputs(config, batch, precision)
        per = _one(prog, ref, width, groups)
        bad = torch.zeros_like(per["frames_off"], dtype=torch.bool)
        for name in names:
            worst[name] = max(worst[name], float(per[name].max()))
            bad |= per[name] > limits[name]
        checked += len(batch.lengths_host)
        failed += int(bad.sum())
        del ref, prog, per
    return ({n: (worst[n], float(limits[n])) for n in names}, checked, failed)


def correct(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
