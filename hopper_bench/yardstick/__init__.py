"""The yardstick: what later changes to the program may not move.

Frozen copies of the seeded text generator and of the work ledger's byte
arithmetic, the plain Snappy block codec the comparison uses, and the
working set every cell is built from. None of it imports the program.
"""
