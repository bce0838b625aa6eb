"""The posterior fit's mean-solve iterations: the kernel launches during
`fit_posterior` (one per CG iteration and one per Lanczos step, by the
program's launch counters) less the Lanczos rank."""


def read(rec):
    total = sum((rec.get("fit_launches") or {}).values())
    if total <= 0:
        return None
    return total - rec["lanczos_rank"]
