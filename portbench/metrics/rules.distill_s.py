"""rules.distill_s: seconds of the rules pipeline on one sweep's times
(the program's ``rules.distill`` spans, one a whole sweep)."""


def read(record: dict):
    span = (record.get("spans") or {}).get("rules.distill")
    if not span or not span["count"]:
        return None
    return span["total_s"] / span["count"]
