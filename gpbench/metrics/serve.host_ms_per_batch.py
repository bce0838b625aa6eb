"""ms a batch of host-only work on the serving request path in the traced
window: the self time of the program's host-only spans (`obs.host_span`:
the batch's assembly and scatter, the Morton sort, the block-sparse CSR),
the worker's wait for work (`serve_batch_wait`) left out, over the window's
`serve_batch` spans. Read from the program's registry in this process
(`span.<name>` totals, kept after tracing stops); None when the program
keeps no span totals."""


def totals() -> dict:
    """Span name -> {"kind", "count", "total_ms", "self_ms"} of the last
    traced window; {} when the program keeps no span totals."""
    from repro_torch import obs

    return {k[len("span."):]: v for k, v in obs.registry().snapshot().items()
            if k.startswith("span.") and isinstance(v, dict) and "kind" in v}


def per_batch(field: str, kind: str, leave_out=()):
    """`field` summed over the spans of `kind`, over the window's batches."""
    spans = totals()
    batches = spans.get("serve_batch", {}).get("count")
    if not batches:
        return None
    return sum(v[field] for name, v in spans.items()
               if v["kind"] == kind and name not in leave_out) / batches


def read(rec):
    return per_batch("self_ms", "host", leave_out=("serve_batch_wait",))
