"""On the card, at each cell's own size: the control (the reference with its
weight products' operands in float8 e4m3, in the port's place) and each
planted fault come out not correct on three seeds.  The benchmark's runs do
not run this; it is what the limits in ``bench/limits`` were read against
(``bench/calibrate.py`` prints the same readings for more seeds)."""
import pytest

from bench import calibrate
from bench.harness import cells, driver
from small import DECODE, PREFILL, TRAIN

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("name", [TRAIN, PREFILL, DECODE])
def test_control_and_faults_are_not_correct(card, name):
    cell = cells.load(name)
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, 8.0, card, control=True)
        assert all(c["ok"] for c in driver.judge(r["program"], cell.limits).values()), r
        for what in ("control", "half_batch", "altered_token"):
            if what in r:
                checks = driver.judge(r[what], cell.limits)
                assert not all(c["ok"] for c in checks.values()), (what, r)
