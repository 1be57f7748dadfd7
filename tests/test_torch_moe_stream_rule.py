"""The rule ``chip_smoke.py`` holds a moe model's served streams to, on
recorded decisions made up here (the card's runs feed it real ones).

A stream that diverges from the plain path's is excused only where its
greedy pick was a near tie, or where the causally first decisions the two
paths took differently in its past were near ties: ordered by call, then
moe layer, and reaching other streams only through calls whose capacity
cut couples them (an idle slot's rows carry the stream that last held it).
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

TIE = 2e-4   # below LOGIT_TOL: a near tie
WIDE = 0.5   # far above it
UNIT = 1e-7  # one unit of f32 at the deciding value


def _rec(dec, calls, margins, streams=None):
    """A recorded run: ``dec[(uid, n, s, layer)] = (chosen, kept, gap)``,
    ``calls[seq] = (streams, coupled)``; the n-th call of a stream is its
    n-th appearance in ``calls``."""
    seq, seen = {}, {}
    for t, (members, _) in sorted(calls.items()):
        for u in members:
            seen[u] = seen.get(u, -1) + 1
            seq[(u, seen[u])] = t
    return {"dec": {k: (c, kept, gap, UNIT, float("inf")) for k, (c, kept, gap) in dec.items()},
            "seq": seq, "calls": {t: [list(m), c] for t, (m, c) in calls.items()},
            "margins": margins, "streams": streams or {}}


def _pair(kernel_routes, plain_routes, calls, margins):
    kernel = _rec({k: (c, c, 0.0) for k, c in kernel_routes.items()}, calls, margins)
    plain = _rec(plain_routes, calls, margins)
    return kernel, plain


CALLS = {0: ([0], False), 1: ([0], False)}  # stream 0's prefill, then one decode


@pytest.mark.parametrize("early, late, ok", [(TIE, WIDE, True), (WIDE, TIE, False)])
def test_the_first_decision_is_taken_by_call_then_layer(early, late, ok):
    """A flip in layer 1 of call 0 precedes one in layer 0 of call 1: the
    verdict follows the earlier one's margin alone."""
    kernel, plain = _pair({(0, 0, 0, 1): (1, 3), (0, 1, 0, 0): (2, 4)},
                          {(0, 0, 0, 1): ((1, 2), (1, 2), early),
                           (0, 1, 0, 0): ((2, 3), (2, 3), late)},
                          CALLS, {(0, 1): (0.3, UNIT, 1)})
    n, first = cs.first_decisions(kernel, plain, [(0, 1)])[(0, 1)]
    assert n == 2
    assert [(e[0], e[1]) for e in first] == [((0, 1), "route")]
    assert all(cs._within(e) for e in first) == ok


@pytest.mark.parametrize("coupled", [True, False])
def test_other_streams_count_only_through_a_capacity_cut(coupled):
    """Stream 1 made no decision differently; stream 0 flipped a near tie
    in call 1, which both shared. Only a capacity cut there makes stream
    0's flip part of stream 1's past."""
    calls = {0: ([0], False), 1: ([0, 1], coupled), 2: ([0, 1], False)}
    kernel, plain = _pair({(0, 1, 0, 0): (1, 3)}, {(0, 1, 0, 0): ((1, 2), (1, 2), TIE)},
                          calls, {(1, 2): (0.3, UNIT, 2)})
    n, first = cs.first_decisions(kernel, plain, [(1, 2)])[(1, 2)]
    assert (n, [e[2] for e in first]) == ((1, [0]) if coupled else (0, []))


def test_an_idle_slot_carries_the_stream_that_last_held_it():
    """Stream 0 retired after a greedy pick at a near tie; its slot then
    rode along idle in a capacity-cut call with stream 1, which diverged
    later with no decision of its own taken differently."""
    idle = ("slot", 0, 0)
    calls = {0: ([0], False), 1: ([0], False), 2: ([idle, 1], True), 3: ([1], False)}
    margins = {(0, 1): (TIE, UNIT, 1), (1, 4): (0.3, UNIT, 3)}
    kernel, plain = _pair({}, {}, calls, margins)
    causes = cs.first_decisions(kernel, plain, [(0, 1), (1, 4)])
    assert [(e[1], e[2]) for e in causes[(1, 4)][1]] == [("greedy", 0)]
    assert causes[(0, 1)] == (0, [])  # a stream's own divergence is not its past


def test_a_capacity_cut_beside_a_router_flip_is_excused_by_it():
    """A token dropped at a wide gate margin because a router flip in the
    same layer of the same call took its expert's capacity."""
    calls = {0: ([0, 1], True), 1: ([0, 1], False)}
    kernel = _rec({(0, 0, 0, 0): ((1, 3), (1, 3), 0.0), (1, 0, 0, 0): ((3, 4), (4,), 0.0)},
                  calls, {})
    plain = _rec({(0, 0, 0, 0): ((1, 2), (1, 2), TIE), (1, 0, 0, 0): ((3, 4), (3, 4), 0.0)},
                 calls, {(1, 1): (0.3, UNIT, 1)})
    plain["dec"][(1, 0, 0, 0)] = ((3, 4), (3, 4), 1.0, UNIT, WIDE)
    divergences = []
    assert cs.moe_streams("t", {1: [5, 6]}, {1: [5, 7]},
                          lambda impl: dict(kernel if impl == "pallas" else plain,
                                            streams={1: [5, 6] if impl == "pallas"
                                                     else [5, 7]}),
                          divergences) == 0
    (d,) = divergences
    assert d["within_rule"] and sorted(e["kind"] for e in d["first"]) == ["capacity", "route"]


@pytest.mark.parametrize("held", [True, False])
def test_a_wide_first_decision_fails_only_where_held(held):
    kernel, plain = _pair({(0, 0, 0, 0): (1, 3)}, {(0, 0, 0, 0): ((1, 2), (1, 2), WIDE)},
                          CALLS, {(0, 1): (0.3, UNIT, 1)})

    def rerun(impl):
        run = kernel if impl == "pallas" else plain
        return dict(run, streams={0: [5, 6] if impl == "pallas" else [5, 7]})

    divergences = []
    if held:
        with pytest.raises(RuntimeError, match="not near ties"):
            cs.moe_streams("t", {0: [5, 6]}, {0: [5, 7]}, rerun, divergences)
    else:
        assert cs.moe_streams("t", {0: [5, 6]}, {0: [5, 7]}, rerun, divergences,
                              held=False) == 0
    assert [d["within_rule"] for d in divergences] == [False]
