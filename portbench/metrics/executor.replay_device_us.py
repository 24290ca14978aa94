"""executor.replay_device_us: the device span of one warm replay of the
fastest design (first operation's start to last one's end), median over
the traced replays."""
import statistics


def read(record: dict):
    warm = [r["span_us"] for r in record.get("replay_trace") or []
            if not r["cold"]]
    return statistics.median(warm) if warm else None
