"""Entries of the program that a traffic mix can drive, one module each,
found by the traffic's `entry`: `run(cell, args, t0, device)` sets the
cell up, measures its window and checks its outputs."""
