"""Tiny sizes shared by the CPU tests of chip_smoke.py
(tests/test_torch_chip_smoke*.py): the card run builds the same models at
full width."""

import chip_smoke

TINY = chip_smoke.Sizes(vocab=1920, hidden=512, inter=1024, heads=4, kv_heads=2, layers=8)
