"""moe.load_imbalance: the busiest expert's token choices over the mean
expert's, before capacity drops, over the traced steps' MoE layer calls
(counters ``moe.load_max`` and ``moe.routed``)."""


def read(record: dict):
    m = record.get("moe_load")
    if not m or not m.get("load_max") or not m.get("routed"):
        return None
    return m["load_max"] / (m["routed"] / m["experts"])
