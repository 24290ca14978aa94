"""mla.fwd_ms: device milliseconds of a train step's latent attention
in the forward (the ``attn.mla`` spans' device intervals, which a layer
checkpoint's recomputation does not open), median over the traced
steps."""
import statistics


def read(record: dict):
    ms = record.get("mla_fwd_ms")
    return statistics.median(ms) if ms else None
