# coding: utf-8
"""Reference-strength end-to-end parity gate at full production scale.

The reference gates the methylium example at 3% of the rate maximum
(reference tests/test_examples.py:101-105). This test runs the production
configuration — 50,000 trajectories x 2000 steps through the real CLI task
functions — gated at 3% of the rate-at-maximum against the
current-torch-reference fixture (tests/data/README.md). The job itself is
`chip_smoke.methylium_parity`, which chip_smoke.py also runs as a phase.

Impractical on CPU, so it runs in the GPU tier and only when explicitly
requested:

    SEMI_GPU_TESTS=1 SEMI_FULL_PARITY=1 python -m pytest tests/test_full_parity.py -q
"""

import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.full_parity, pytest.mark.slow]


def test_methylium_rate_parity_3pct_full_scale():
    import chip_smoke

    out = chip_smoke.methylium_parity(ntraj=50000, nt=2000, seed=1234)
    assert out["rate_max_dev"] < 0.03
