"""Drivers of the program's entry points, one per file, chosen by a
traffic mix's ``entry`` key."""
