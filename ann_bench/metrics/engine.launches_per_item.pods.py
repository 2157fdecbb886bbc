"""``engine.launches_per_item``, in the four-card cell, which reports ``items_per_s.pods``."""
from ann_bench.harness import load_reader

read = load_reader("engine.launches_per_item")
