"""ms a batch that the closed batcher's worker waited for work in the traced
window: the self time of the program's `serve_batch_wait` spans (from the
worker's first `get` until the batch closes) over the window's
`serve_batch` spans (the registry's `span.<name>` totals); None when the
program keeps no span totals."""
import os

from gpbench.harness import manifest

_totals = manifest.load_part(
    "metrics", "serve.host_ms_per_batch",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).totals


def read(rec):
    spans = _totals()
    batches = spans.get("serve_batch", {}).get("count")
    wait = spans.get("serve_batch_wait")
    if not batches or wait is None:
        return None
    return wait["self_ms"] / batches
