"""protocol.class_retention_pct: the share of designs that the rules'
labels (the program's ``label_times`` on each sweep's times) put in the
same class in the first two whole sweeps, in percent."""


def read(record: dict):
    sweeps = record.get("sweeps") or []
    if len(sweeps) < 2:
        return None
    a, b = sweeps[0]["labels"], sweeps[1]["labels"]
    keys = [k for k in a if k in b]
    if not keys:
        return None
    return 100.0 * sum(a[k] == b[k] for k in keys) / len(keys)
