# coding: utf-8
"""CPU rehearsal of chip_smoke.py's molecular phases at toy sizes: the
sGDML coumarin HK and WM jobs and the methylium job, through the same CLI
calls and gates as on the card (see test_chip_smoke.py)."""

import chip_smoke


def test_coumarin_hk_phase_toy():
    out = chip_smoke.coumarin_hk(ntraj=16, nt=16)
    assert out["sizes"]["ntraj"] == 16 and all(out["gates"].values())


def test_coumarin_wm_phase_toy():
    out = chip_smoke.coumarin_wm(ntraj=16, nt=8)
    assert all(out["gates"].values())


def test_methylium_parity_phase_toy():
    out = chip_smoke.methylium_parity(ntraj=64, nt=20,
                                      compare_reference=False)
    assert out["c0_dev"] < 1e-2
