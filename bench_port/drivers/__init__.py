"""Drivers: one module per traffic-mix `kind`, each with a `Run(cell, seed, device)`
that sets the cell up (inputs from the seed, the program's state, its first checked
calls and the warm-up) and offers `window(seconds)`, `traced()`, `work(ctx)`,
`release()` and `check(precision, fault)`.

This package is the only part of the benchmark that imports the program
(`langsplat_tpu_torch`): `program.py` holds what the drivers share.
"""
