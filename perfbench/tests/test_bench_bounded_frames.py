"""``bounded_frames_pct``: the program's ``frames_bounded`` counter over its
``frames_computed``, on made-up span windows and one traced on the CPU."""

import types

import pytest

from perfbench import corpus as corpus_mod, harness, spans
from perfbench.tests.hostdev import Host, tiny_cell


def _run(counters):
    t = None if counters is None else dict(
        batches=1, lengths=[], counters=counters, span_device_s={},
        syncs=[], untied_s=0.0)
    return types.SimpleNamespace(spans=t, trace={"dev_ops": [("k", 0, 1)]})


@pytest.mark.parametrize("counters,want", [
    (None, None),                                      # nothing traced
    ({"frames_computed": 300}, None),                  # no such counter
    ({"frames_computed": 300, "frames_direct": 0}, None),
    ({"frames_computed": 0, "frames_bounded": 0}, None),
    ({"frames_computed": 300, "frames_bounded": 0}, 0.0),
    ({"frames_computed": 300, "frames_bounded": 300}, 100.0),
    ({"frames_computed": 400, "frames_bounded": 100}, 25.0),
])
def test_bounded_frames_pct(counters, want):
    assert harness.reader("bounded_frames_pct")(_run(counters)) == want


def test_no_bounded_frames_on_the_cpu_stand_in():
    """The CPU stand-in runs the plain chain, no tile: 0 % of the frames
    the program's spans' window computed."""
    cell = tiny_cell("whisper128.libri_sorted")
    corpus = corpus_mod.build(cell.traffic, 11, Host.device)
    t = spans.collect(corpus, harness.program_entry(cell.config), Host(),
                      int(cell.traffic["queue_depth"]))
    assert t["counters"]["frames_computed"] > 0
    r = types.SimpleNamespace(spans=t, cell=cell, trace={"dev_ops": [1]})
    assert harness.reader("bounded_frames_pct")(r) == 0.0
