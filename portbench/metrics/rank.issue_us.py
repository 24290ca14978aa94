"""rank.issue_us: host microseconds to issue one step (a fixed count of
``run.step()`` without a sync, over the count), on the slowest rank."""


def read(record: dict):
    return record.get("issue_us")
