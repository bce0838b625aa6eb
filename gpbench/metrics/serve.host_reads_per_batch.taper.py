"""Reads from the card a batch on the serving request path in the traced
window: the program's read spans (`obs.read_span`: the Morton sort's read of
the queries, each chunk's tile count and tile list, the block's mean and
variance), counted, over the window's `serve_batch` spans (the registry's
`span.<name>` totals); None when the program keeps no span totals."""
import os

from gpbench.harness import manifest

_per_batch = manifest.load_part(
    "metrics", "serve.host_ms_per_batch",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).per_batch


def read(rec):
    return _per_batch("count", "read")
