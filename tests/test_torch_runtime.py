"""The port's runtime pieces against the reference's, same seed for same
seed: DeterministicRandom (runtime/core.py) gives the same draws, splits
included; buggify (runtime/buggify.py) the same armed and fired census for
the same enable seed and site queries, forced sites included; the port's
CoreKnobs (runtime/knobs.py) the reference CoreKnobs' DEVICE_* defaults, and the
port's supervisor reads a reference cluster's randomized knobs as the
reference's supervisor does."""

import pytest

from foundationdb_tpu.conflict import supervisor as jsupervisor
from foundationdb_tpu.runtime import buggify as jbuggify
from foundationdb_tpu.runtime import core as jcore
from foundationdb_tpu.runtime import coverage as jcoverage
from foundationdb_tpu.runtime import knobs as jknobs
from foundationdb_tpu_torch.conflict import supervisor
from foundationdb_tpu_torch.runtime import buggify, core, coverage, knobs


@pytest.fixture(autouse=True)
def _port_census_isolation():
    cov = coverage.snapshot()
    coverage.reset()
    buggify.disable()
    yield
    buggify.disable()
    coverage.restore(cov)


def _draws(r):
    """Coin flips at several odds, interleaved with splits, then a
    child's flips."""
    out = []
    for i in range(200):
        out.append(r.coinflip((i % 10) / 10))
        if i % 37 == 0:
            out.append(r.split().seed)
    child = r.split()
    out += [child.seed, [child.coinflip() for _ in range(20)], r.coinflip()]
    return out


@pytest.mark.parametrize("seed", [0, 1, 20260729, 2**63 - 1])
def test_deterministic_random_matches_the_reference(seed):
    assert _draws(core.DeterministicRandom(seed)) == _draws(jcore.DeterministicRandom(seed))


SITES = ("device.lost", "device.dispatch_hang", "device.compile_fail",
         "device.readback_corrupt", "tlog.push_drop", "proxy.early_fire")


def _buggify_run(mod, rng_cls, cov, seed: int):
    """Enable from `seed`, force two sites, query the sites in a fixed
    order; returns the fire pattern, the census and the coverage hits."""
    mod.enable(rng_cls(seed), enable_prob=0.5, fire_prob=0.3)
    mod.force("device.lost", 3)
    mod.force("never.queried", 1)
    base = cov.snapshot()
    fired = [mod.buggify(SITES[i % len(SITES)]) for i in range(300)]
    out = fired, mod.census(), cov.census(base)
    mod.disable()
    return out


@pytest.mark.parametrize("seed", [1, 7, 1500])
def test_buggify_census_matches_the_reference(seed):
    got = _buggify_run(buggify, core.DeterministicRandom, coverage, seed)
    want = _buggify_run(jbuggify, jcore.DeterministicRandom, jcoverage, seed)
    assert got == want
    fired, census, hits = got
    assert census["never.queried"] == {"armed": True, "fires": 0}
    assert census["device.lost"]["fires"] >= 3
    assert any(fired) and not all(fired)
    assert hits["buggify.device.lost"] == census["device.lost"]["fires"]


def test_buggify_off_never_fires():
    buggify.force("device.lost", 2)  # not honored outside simulation
    assert not buggify.buggify("device.lost")
    buggify.enable(core.DeterministicRandom(3), enable_prob=1.0, fire_prob=1.0)
    assert buggify.census() == {}
    assert buggify.buggify("x")
    assert buggify.census() == {"x": {"armed": True, "fires": 1}}
    buggify.disable()
    assert buggify.census() == {}
    assert not buggify.buggify("x")


DEVICE_KNOBS = ("DEVICE_WATCHDOG_S", "DEVICE_RETRY_LIMIT", "DEVICE_RETRY_BACKOFF",
                "DEVICE_MAX_BACKOFF", "DEVICE_REPROBE_INTERVAL")


def test_device_knobs_match_the_reference_defaults():
    want = jknobs.CoreKnobs()
    for name in DEVICE_KNOBS:
        assert getattr(knobs.CoreKnobs(), name) == getattr(want, name), name
    assert sorted(n for n in knobs.CoreKnobs().names()
                  if n.startswith("DEVICE_")) == sorted(DEVICE_KNOBS)


def _supervised_knobs(sup):
    return (sup.watchdog_s, sup.retry_limit, sup.backoff0, sup.max_backoff,
            sup.reprobe_interval, sup._watchdog.timeout_s)


@pytest.mark.parametrize("seed", [2, 11, 1234, 99991])
def test_supervisor_reads_randomized_reference_knobs(seed):
    """A reference cluster hands its resolver's backend its own CoreKnobs,
    randomized under simulation: the port's supervisor reads the DEVICE_*
    values from it as the reference's supervisor does, and without knobs
    it runs on the same defaults."""
    k = jknobs.CoreKnobs(randomize=jcore.DeterministicRandom(seed))
    assert k.DEVICE_RETRY_BACKOFF != jknobs.CoreKnobs().DEVICE_RETRY_BACKOFF
    never = lambda oldest: pytest.fail("construction must not build the device")  # noqa: E731
    got = supervisor.DeviceSupervisor(never, knobs=k)
    want = jsupervisor.DeviceSupervisor(never, knobs=k)
    assert _supervised_knobs(got) == _supervised_knobs(want)
    assert got.backoff0 == k.DEVICE_RETRY_BACKOFF
    assert got.reprobe_interval == k.DEVICE_REPROBE_INTERVAL
    assert _supervised_knobs(supervisor.DeviceSupervisor(never)) == \
        _supervised_knobs(jsupervisor.DeviceSupervisor(never))
