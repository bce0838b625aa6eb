"""Share (%) of the window's Eq. 2 backward phases that ran the fused
kernel (B5): the engine's `eq2_backward` spans whose `route` is "fused",
over those that carry a `route`. None where no span carries one (a program
that does not stamp the route)."""


def read(rec):
    routes = [e["args"]["route"] for e in rec.get("spans") or []
              if e.get("name") == "eq2_backward" and "route" in e.get("args", {})]
    return 100.0 * routes.count("fused") / len(routes) if routes else None
