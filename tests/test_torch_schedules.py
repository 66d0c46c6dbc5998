"""The port's pipeline schedules against the JAX package's: every
``Schedule.plan(t, d)`` field, ``describe()`` and the validation errors
are equal (the plan is integer arithmetic: nothing is approximate)."""
import pytest

from repro.transport import schedules as JS

from repro_torch.transport import schedules as TS

STAGES = (2, 3, 4)
CASES = [("gpipe", None), ("1f1b", None), ("interleaved", 1),
         ("interleaved", 2), ("interleaved", 3)]


def _ref_plan(p):
    return (int(p.k), int(p.j), bool(p.valid), bool(p.inject), bool(p.last))


def _microbatches(name, s):
    return [mb for mb in range(1, 9) if name != "interleaved" or mb % s == 0]


@pytest.mark.parametrize("name,v", CASES)
@pytest.mark.parametrize("s", STAGES)
def test_plan_and_describe_match(name, v, s):
    jsch, tsch = JS.get_schedule(name, v), TS.get_schedule(name, v)
    for mb in _microbatches(name, s):
        jsch.validate(mb, s)
        tsch.validate(mb, s)
        assert tsch.describe(mb, s) == jsch.describe(mb, s)
        ticks = tsch.num_ticks(mb, s)
        for t in range(ticks + 1):             # t + 1: the receive side
            for d in range(s):
                got = tsch.plan(t, d, mb, s)
                assert (got.k, got.j, got.valid, got.inject,
                        got.last) == _ref_plan(jsch.plan(t, d, mb, s)), \
                    (name, v, s, mb, t, d)


@pytest.mark.parametrize("name,v", CASES)
@pytest.mark.parametrize("s", STAGES)
def test_every_pair_computes_once(name, v, s):
    """The invariant the port's loop rests on: the valid ticks cover every
    (microbatch, logical stage) pair exactly once, and stage l+1 of a
    microbatch runs the tick after stage l."""
    sch = TS.get_schedule(name, v)
    for mb in _microbatches(name, s):
        when = {}
        for t in range(sch.num_ticks(mb, s)):
            for d in range(s):
                p = sch.plan(t, d, mb, s)
                if p.valid:
                    key = (p.j, p.k * s + d)
                    assert key not in when
                    when[key] = t
        lv = sch.virtual_stages * s
        assert sorted(when) == [(j, lg) for j in range(mb)
                                for lg in range(lv)]
        for j in range(mb):
            assert [when[(j, lg)] for lg in range(lv)] == \
                list(range(when[(j, 0)], when[(j, 0)] + lv))


@pytest.mark.parametrize("call", [
    lambda m: m.get_schedule("nope"),
    lambda m: m.get_schedule("gpipe", 2).validate(4, 2),
    lambda m: m.get_schedule("1f1b", 2).validate(4, 2),
    lambda m: m.get_schedule("interleaved", 2).validate(3, 2),
    lambda m: m.get_schedule("interleaved", 0).validate(2, 2),
    lambda m: m.as_schedule(m.get_schedule("interleaved", 2), 3),
])
def test_errors_match(call):
    with pytest.raises(ValueError) as jerr:
        call(JS)
    with pytest.raises(ValueError) as terr:
        call(TS)
    assert str(terr.value) == str(jerr.value)


def test_as_schedule_and_defaults():
    for name in TS.SCHEDULES:
        t, j = TS.as_schedule(name), JS.as_schedule(name)
        assert (t.name, t.virtual_stages, t.fused_wire, t.remat_ticks) == \
            (j.name, j.virtual_stages, j.fused_wire, j.remat_ticks)
        assert TS.as_schedule(t) is t
