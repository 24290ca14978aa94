"""tokens_per_s: tokens trained in the window over its host seconds."""


def read(record: dict):
    if not record.get("tokens") or not record.get("window_s"):
        return None
    return record["tokens"] / record["window_s"]
