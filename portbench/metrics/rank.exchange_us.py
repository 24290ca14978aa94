"""rank.exchange_us: microseconds of one halo exchange alone (the
program's ``halo_exchange`` and its waits), a fixed count back to back
and drained, on the slowest rank."""


def read(record: dict):
    return record.get("exchange_us")
