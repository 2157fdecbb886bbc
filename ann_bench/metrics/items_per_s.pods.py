"""``items_per_s`` of the four-card cell, under a bound of its own: its
runs spread wider than one card's (PERF.md section 2)."""
from ann_bench.harness import load_reader

read = load_reader("items_per_s")
