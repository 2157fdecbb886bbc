"""``query_p90_ms`` as a per-layer metric of the four-card cell, read in the
traced run over the query ops after the traced rounds."""
from ann_bench.harness import load_reader

read = load_reader("query_p90_ms")
