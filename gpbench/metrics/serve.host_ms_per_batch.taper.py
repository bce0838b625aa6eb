"""`serve.host_ms_per_batch` in the cells that report `fit_s` and no window
metric end to end (taper-serve; PERF.md, section 2): the same reader."""
import os

from gpbench.harness import manifest

read = manifest.load_part(
    "metrics", "serve.host_ms_per_batch",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).read
