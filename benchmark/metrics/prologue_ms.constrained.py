"""prologue_ms.constrained: the mean length of the program's
`nomad.solve.prologue` ranges in the traced pass (each solve's entry to
its first wave: the uploads, the static feasibility, the affinity plane,
the spread lookups, the jitter, the bit-packing and the graph plan's
input copies), ms a solve; nothing where the program opens no such
range."""


def read(out):
    spans = out["layer"].get("prologue_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
